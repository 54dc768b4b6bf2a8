"""The one launch path of the port's kernels, ``ops/_kernels.launch``, on
the CPU: a stand-in ctypes function takes the call, and torch's CUDA
stream and device queries are stand-ins too (this torch has none).  Then an
AST check that no wrapper in ``ops/`` reaches a stream, a device guard or a
library by itself."""

import ast
import os

import pytest
import torch

from cogview_tpu_torch.ops import _kernels

OPS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "cogview_tpu_torch", "ops")
STREAM = 0x5EED


class FakeLib:
    """A loaded library whose functions record their calls and return
    ``err``; ``resolved`` counts the attribute lookups."""

    def __init__(self, err=0):
        self.err, self.calls, self.resolved = err, [], 0

    def __getattr__(self, name):
        if name.startswith("probe_") or name.startswith("flash_") or name.startswith("decode_"):
            self.resolved += 1
            return lambda *args: self.calls.append((name, args)) or self.err
        raise AttributeError(name)


class FakeGuard:
    entered = []

    def __init__(self, index):
        self.index = index

    def __enter__(self):
        FakeGuard.entered.append(self.index)

    def __exit__(self, *exc):
        return False


@pytest.fixture
def fake_cuda(monkeypatch):
    """-> a function making a FakeLib that ``_kernels.lib`` returns, with the
    current device 0 and every stream handle STREAM + index."""
    monkeypatch.setattr(_kernels, "_FNS", {})
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: STREAM + i,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", FakeGuard)
    FakeGuard.entered = []
    libs = {}

    def make(err=0):
        fake = FakeLib(err)
        monkeypatch.setattr(_kernels, "lib", lambda name: libs.setdefault(name, fake))
        return fake

    return make


def test_launch_passes_the_arguments_and_the_stream_last(fake_cuda):
    fake = fake_cuda()
    _kernels.launch("probes", "probe_add_one", torch.device("cuda", 0), 11, 22, 1024)
    assert fake.calls == [("probe_add_one", (11, 22, 1024, STREAM))]
    assert FakeGuard.entered == []  # device 0 is the current one


def test_launch_resolves_each_function_once(fake_cuda):
    fake = fake_cuda()
    dev = torch.device("cuda", 0)
    for i in range(5):
        _kernels.launch("probes", "probe_add_one", dev, i)
        _kernels.launch("probes", "probe_seal_scatter", dev, i)
    assert fake.resolved == 2 and len(fake.calls) == 10
    assert [args[0] for name, args in fake.calls if name == "probe_add_one"] == list(range(5))


def test_launch_guards_only_another_device(fake_cuda):
    fake = fake_cuda()
    _kernels.launch("probes", "probe_add_one", torch.device("cuda", 0), 1)
    _kernels.launch("probes", "probe_add_one", torch.device("cuda", 1), 2)
    _kernels.launch("probes", "probe_add_one", torch.device("cuda", 0), 3)
    assert FakeGuard.entered == [1]
    assert [args[-1] for _, args in fake.calls] == [STREAM, STREAM + 1, STREAM]


def test_launch_raises_on_a_cuda_error(fake_cuda):
    fake_cuda(err=700)
    with pytest.raises(RuntimeError, match="probe_add_one launch failed: CUDA error 700"):
        _kernels.launch("probes", "probe_add_one", torch.device("cuda", 0), 1)


def _calls(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return [ast.unparse(n.func) for n in ast.walk(tree) if isinstance(n, ast.Call)]


# what only _kernels.launch may do: read a stream, enter a device guard,
# reach a loaded library
FORBIDDEN = ("current_stream", "torch.cuda.device", "_kernels.lib", "lib", "cuda_stream")


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(OPS)
                                        if f.endswith(".py") and f != "_kernels.py"))
def test_only_launch_reaches_a_kernel(name):
    calls = _calls(os.path.join(OPS, name))
    bad = [c for c in calls if c in FORBIDDEN or c.endswith(".current_stream")
           or c.endswith(".cuda_stream")]
    assert bad == [], f"{name} launches by itself: {bad}"
    # the three wrapper modules launch through _kernels.launch
    if name in ("decode_attention.py", "flash_attention.py", "probes.py"):
        assert "launch" in calls


def test_launch_is_defined_once():
    defs = {}
    for name in os.listdir(OPS):
        if name.endswith(".py"):
            with open(os.path.join(OPS, name)) as f:
                for n in ast.walk(ast.parse(f.read())):
                    if isinstance(n, ast.FunctionDef) and n.name in ("launch", "_launch"):
                        defs.setdefault(n.name, []).append(name)
    assert defs == {"launch": ["_kernels.py"]}
