"""The native artifact host's CUDA graph path, as far as the CPU can show it.

On the card `rtpu_host` serves each step program as one captured CUDA graph
(csrc/rtpu_host.cc, `RTPU_HOST_CUDA_GRAPHS`); here it is built against the
CPU wheel and runs the steps eagerly. The checks:

  * `build_command` on a CUDA wheel (faked: `torch.version.cuda` and
    `cpp_extension.CUDA_HOME` patched) compiles the graph path against
    `$CUDA_HOME/include`, raises naming `CUDA_HOME` where the toolkit's
    headers are not found, and on the CPU wheel carries neither;
  * `info` and every streaming command say how the steps ran, and `bench`
    on the CPU prints the eager line alone;
  * no step program of a tiny v2, `discrete`, v3 or prior artifact holds a
    node that reads a tensor on the host, which a capture refuses.

The streams, the AdaIN sequence and the prior, bit-equal to the Python
artifact with the state written in place, are tests/test_torch_native_host.py's.
"""
from pathlib import Path

import pytest
import torch
from torch.utils import cpp_extension

from rave_tpu_torch.export import native_host
from rave_tpu_torch.export.export import export_model
from tests.test_torch_native_host import (  # noqa: F401 (fixtures)
    N_BLOCKS, SEED, host, port_run, prior_art, run_host, signal, two_torch_threads, v2, v3,
    write_wav,
)

TINY_DISCRETE = ["capacity=2", "discriminator.capacity=2", "latent_size=4", "ratios=[4,4,2]",
                 "dilations=[[1],[1],[1]]", "latent.num_quantizers=3", "latent.codebook_size=16"]
GRAPH_DEFINE = "-DRTPU_HOST_CUDA_GRAPHS"
# nodes that read a tensor's value on the host: a synchronize, refused inside a capture
HOST_READS = ("aten::item", "aten::_local_scalar_dense", "aten::nonzero", "aten::tolist",
              "prim::tolist")
# a tensor's value as a number: a host read where the tensor comes from the program's inputs
# (the trace's shape arithmetic, from `aten::size` through `prim::NumToTensor`, stays on the host)
TO_NUMBER = ("aten::Int", "aten::Float", "aten::Bool", "aten::ScalarImplicit")
HOST_VALUES = ("prim::Constant", "prim::NumToTensor", "aten::size", "aten::dim")


def from_inputs(graph) -> set:
    """The values of the traced `graph` (no sub-blocks: nodes in topological
    order) computed from its inputs (its state, block or seed), by name:
    not those from sizes and constants alone."""
    derived = {v.debugName() for v in graph.inputs()}
    for node in graph.nodes():
        if node.kind() not in HOST_VALUES and any(
                v.debugName() in derived for v in node.inputs()
                if v.type().kind() in ("TensorType", "ListType", "TupleType")):
            derived.update(v.debugName() for v in node.outputs())
    return derived


@pytest.fixture(scope="module")
def discrete(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_discrete")
    run = port_run(root, ["discrete"], TINY_DISCRETE, seed=2)
    return export_model(run=str(run), output=str(root / "art"), streaming=True, device="cpu")


def fake_cuda_wheel(monkeypatch, cuda_home):
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None if cuda_home is None else str(cuda_home))


def test_build_command_cuda_wheel(monkeypatch, tmp_path):
    (tmp_path / "include").mkdir()
    (tmp_path / "include" / "cuda_runtime_api.h").write_text("")
    fake_cuda_wheel(monkeypatch, tmp_path)
    cmd = native_host.build_command(Path("rtpu_host"))
    assert GRAPH_DEFINE in cmd
    at = cmd.index(str(tmp_path / "include"))
    assert cmd[at - 1] == "-isystem" and at < cmd.index(str(native_host.SOURCE))
    assert "-ltorch_cuda" in cmd and "-lc10_cuda" in cmd


@pytest.mark.parametrize("headers", ["no CUDA_HOME", "no headers"])
def test_build_command_cuda_wheel_needs_the_toolkit(monkeypatch, tmp_path, headers):
    fake_cuda_wheel(monkeypatch, None if headers == "no CUDA_HOME" else tmp_path)
    with pytest.raises(RuntimeError, match="CUDA_HOME"):
        native_host.build_command(Path("rtpu_host"))


def test_build_command_cpu_wheel():
    assert torch.version.cuda is None
    cmd = native_host.build_command(Path("rtpu_host"))
    assert GRAPH_DEFINE not in cmd and "-ltorch_cuda" not in cmd
    assert not any(c.rstrip("/").endswith("cuda/include") for c in cmd)


def test_cpu_steps_run_eagerly(host, v2, tmp_path):
    """`info`, `bench 4` and `encode` on a CPU artifact: eager steps on the
    CPU, the bench's eager line and no graph line, one step per block."""
    info = run_host(host, v2["mono"], "info").stdout.splitlines()
    assert "steps: eager on the cpu" in info
    bench = run_host(host, v2["mono"], "bench", 4).stdout.splitlines()
    assert any(line.startswith("per-block forward eager: p50 ") for line in bench)
    assert not any(line.startswith(("per-block forward: ", "graph vs eager", "steps: "))
                   for line in bench)
    block = int(next(line for line in info if line.startswith("block_size: ")).split()[-1])
    wav = write_wav(tmp_path / "in.wav", signal(N_BLOCKS * block - 100, 1))
    out = run_host(host, v2["mono"], "encode", wav, tmp_path / "z.f32", SEED).stdout.splitlines()
    assert out[-2] == f"steps: eager on the cpu, {N_BLOCKS} calls", out


def test_prior_reports_its_steps(host, prior_art, tmp_path):
    out = run_host(host, prior_art, "prior", 5, tmp_path / "z.f32", 1).stdout.splitlines()
    assert out[-2] == "steps: eager on the cpu, 6 calls", out  # 5 frames + latent 2 - 1


@pytest.mark.parametrize("which", ["v2", "discrete", "v3", "prior"])
def test_step_programs_read_nothing_on_the_host(v2, discrete, v3, prior_art, which):
    """Every `.ts` step program of the artifact, its submodules inlined,
    holds no node that reads a tensor on the host (`aten::item`, `nonzero`,
    `Int` / `Float` of a tensor computed from its inputs, ...): such a node
    synchronizes, and a CUDA graph capture refuses it."""
    path = Path({"v2": v2["mono"], "discrete": discrete, "v3": v3, "prior": prior_art}[which])
    programs = sorted(path.glob("*_step.ts"))
    assert len(programs) == (4 if which == "prior" else 3)
    for program in programs:
        module = torch.jit.load(str(program))  # alive while its graph is walked
        graph = module.forward.graph.copy()
        torch._C._jit_pass_inline(graph)
        assert not any(list(node.blocks()) for node in graph.nodes())
        derived = from_inputs(graph)
        assert next(graph.outputs()).debugName() in derived  # the walk reached the outputs
        found = [kind for kind in HOST_READS for _ in graph.findAllNodes(kind, True)] + [
            kind for kind in TO_NUMBER for node in graph.findAllNodes(kind, True)
            if node.inputsAt(0).debugName() in derived]
        assert not found, (program.name, found)
