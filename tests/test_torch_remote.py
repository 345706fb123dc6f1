"""The remote dataset: rave_tpu_torch's HTTP client and server against rave_tpu's.

Each package's server (the JAX one in its own process, the port's in a
thread of this one) serves the same store on a localhost port. The port's
`HTTPAudioDataset` must read from either exactly what the JAX client
reads, and `get_dataset("http://...")` through the port's `Loader` must
give the JAX loader's batches (transposed to [B, C, T]) and the same
`Loader`'s batches over the local store, bit for bit. Unknown routes and
indices out of range are 404s. C20: `train` on a URL raises
FileNotFoundError in both packages, where `get_training_channels` reads
`<url>/metadata.yaml`.
"""
import json
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from rave_tpu.config import compose as jax_compose
from rave_tpu.data.dataset import HTTPAudioDataset as JaxHTTPAudioDataset
from rave_tpu.data.dataset import get_dataset as jax_get_dataset
from rave_tpu.data.loader import Loader as JaxLoader
from rave_tpu.data.store import get_training_channels as jax_get_training_channels
from rave_tpu.train import loop as jax_loop
from rave_tpu_torch.config import compose
from rave_tpu_torch.data.dataset import HTTPAudioDataset, get_dataset
from rave_tpu_torch.data.loader import Loader
from rave_tpu_torch.data.server import make_server
from rave_tpu_torch.data.store import ArsWriter, get_training_channels
from rave_tpu_torch.train import loop

ROOT = Path(__file__).resolve().parents[1]
SR, NUM_SIGNAL, N_RECORDS, CHANNELS = 22050, 3000, 9, 2


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_remote") / "db"
    w = ArsWriter(str(root), num_signal=NUM_SIGNAL, channels=CHANNELS, sr=SR)
    rng = np.random.default_rng(0)
    for _ in range(N_RECORDS):
        w.append((rng.standard_normal((NUM_SIGNAL, CHANNELS)) * 6000).astype(np.int16))
    w.close()
    return str(root)


@pytest.fixture(scope="module")
def servers(store):
    """{"port": url of the port's server, "jax": url of the JAX package's}."""
    port_server = make_server(store, free_port(), host="127.0.0.1")
    thread = threading.Thread(target=port_server.serve_forever, daemon=True)
    thread.start()
    jax_port = free_port()
    jax_server = subprocess.Popen(
        [sys.executable, "-c",
         f"from rave_tpu.data.server import serve; serve({store!r}, {jax_port})"],
        cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        assert f"({N_RECORDS} examples)" in jax_server.stdout.readline()
        yield {"port": f"http://127.0.0.1:{port_server.server_address[1]}",
               "jax": f"http://127.0.0.1:{jax_port}"}
    finally:
        jax_server.kill()
        jax_server.wait()
        port_server.shutdown()
        port_server.server_close()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_client_matches_jax_client(servers, server):
    url = servers[server]
    ours, ref = HTTPAudioDataset(url), JaxHTTPAudioDataset(url)
    assert len(ours) == len(ref) == N_RECORDS
    for i in range(N_RECORDS):
        got, want = ours.get(i, None), ref.get(i, None)
        assert got.shape == (NUM_SIGNAL, CHANNELS) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_servers_send_the_same_bytes(servers):
    for route in ("/len", "/get/0", "/get/8"):
        bodies = [urllib.request.urlopen(servers[k] + route).read() for k in ("port", "jax")]
        assert json.loads(bodies[0]) == json.loads(bodies[1])
    for route in ("/get/9", "/get/x", "/nothing"):
        for k in ("port", "jax"):
            with pytest.raises(urllib.error.HTTPError) as info:
                urllib.request.urlopen(servers[k] + route)
            assert info.value.code == 404


@pytest.mark.parametrize("server", ["port", "jax"])
def test_remote_loader_matches_local_and_jax(servers, store, server):
    url = servers[server]
    remote = get_dataset(url, SR, 2048)
    assert isinstance(remote, HTTPAudioDataset)
    local = get_dataset(store, SR, 2048)
    ref = jax_get_dataset(url, SR, 2048)
    idx = np.arange(N_RECORDS)
    for host_id in (0, 1):
        kw = dict(seed=5, workers=2, host_id=host_id, host_count=2)
        got = list(Loader(remote, idx, 2, **kw).epoch(1))
        want_local = list(Loader(local, idx, 2, **kw).epoch(1))
        want_jax = list(JaxLoader(ref, idx, 2, **kw).epoch(1))
        assert len(got) == len(want_local) == len(want_jax) == 2
        for g, w, j in zip(got, want_local, want_jax):
            assert g.shape == (2, CHANNELS, 2048)
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, j.transpose(0, 2, 1))


def test_train_on_a_url_raises_as_jax(tmp_path):
    """C20: both packages' `train` read the URL's metadata.yaml first."""
    url = "http://127.0.0.1:9/"
    for channels in (get_training_channels, jax_get_training_channels):
        with pytest.raises(FileNotFoundError):
            channels(url, 1)
    with pytest.raises(FileNotFoundError):
        loop.train(compose(["v2"]), url, out_path=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        jax_loop.train(jax_compose(["v2"]), url, out_path=str(tmp_path))
    assert not list(tmp_path.iterdir())
