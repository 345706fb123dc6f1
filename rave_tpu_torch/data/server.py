"""The remote dataset's REST server (the flask scripts/remote_dataset.py
equivalent, on stdlib http.server): the port's counterpart of
rave_tpu/data/server.py, over the port's own `ArsReader`.

Routes: `/len` -> {"length": N}; `/get/<i>` -> {"data": base64 of record i
as little-endian int16 [num_signal, channels], "channels", "sr"}; anything
else, or an index out of range, a 404 with {"error": ...}.
`data/dataset.py::HTTPAudioDataset` is its client.
"""
from __future__ import annotations

import base64
import json
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from rave_tpu_torch.data.store import ArsReader


def make_server(db_path: str, port: int = 5000, host: str = "0.0.0.0") -> HTTPServer:
    """The server of `db_path`'s records on `host:port`, not yet serving."""
    reader = ArsReader(db_path)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/len":
                return self._json({"length": len(reader)})
            if self.path.startswith("/get/"):
                try:
                    i = int(self.path.split("/")[-1])
                    if not 0 <= i < len(reader):
                        raise IndexError(i)
                    rec = reader[i]
                except (ValueError, IndexError):
                    return self._json({"error": "bad index"}, 404)
                return self._json({
                    "data": base64.b64encode(np.ascontiguousarray(rec, "<i2").tobytes()).decode(),
                    "channels": int(rec.shape[1]),
                    "sr": reader.meta["sr"],
                })
            return self._json({"error": "not found"}, 404)

        def log_message(self, *a):
            pass

    server = HTTPServer((host, port), Handler)
    server.n_records = len(reader)
    return server


def serve(db_path: str, port: int = 5000, host: str = "0.0.0.0") -> None:
    server = make_server(db_path, port, host)
    print(f"serving {db_path} ({server.n_records} examples) on :{port}", flush=True)
    server.serve_forever()
