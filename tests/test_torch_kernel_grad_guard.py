"""The kernel wrappers refuse gradient-tracked inputs.

Each wrapper (``kernels/{flash_attention,wkv6,ssd,committee_uq}.py``)
launches through ``ctypes`` on raw pointers, so autograd sees no operation:
its output would carry no gradient (ordinary autograd) or the launch would
fail on ``data_ptr`` (``torch.func.grad``).  Its first check refuses such a
call with a ``RuntimeError`` that names ``impl="plain"``, before any device
check, so CPU tensors reach it here.  ``ops.*`` on CPU tensors runs the
plain versions and stays differentiable."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import committee_uq as cuq_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.kernels import wkv6 as wkv_kernel

GUARD = r"has no backward.*impl=\"plain\""
# the device check that follows the guard: no CUDA here, or a CPU tensor
DEVICE_CHECK = "CUDA is not available|expected the CUDA device"


def _rand(*shape, seed=0, scale=1.0):
    rng = np.random.RandomState(seed + len(shape) + sum(shape))
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _inputs(name):
    """(wrapper call, the floating inputs it takes) at a small shape."""
    if name == "flash_attention":
        q, k, v = _rand(1, 8, 4, 16), _rand(1, 8, 2, 16), _rand(1, 8, 2, 16)
        return (lambda q, k, v: fa_kernel.flash_attention(q, k, v)), [q, k, v]
    if name == "wkv6":
        r, k, v = _rand(1, 8, 2, 16), _rand(1, 8, 2, 16, seed=1), \
            _rand(1, 8, 2, 16, seed=2)
        w = torch.sigmoid(_rand(1, 8, 2, 16, seed=3))
        u = _rand(2, 16)
        return (lambda r, k, v, w, u: wkv_kernel.wkv6(r, k, v, w, u,
                                                      chunk=8)), \
            [r, k, v, w, u]
    if name == "ssd":
        x = _rand(1, 8, 2, 16)
        a = torch.sigmoid(_rand(1, 8, 2))
        b, c = _rand(1, 8, 2, 8), _rand(1, 8, 2, 8, seed=1)
        return (lambda x, a, b, c: ssd_kernel.ssd(x, a, b, c, chunk=8)), \
            [x, a, b, c]
    if name == "committee_uq":
        return (lambda p: cuq_kernel.committee_uq(p, 0.1)), [_rand(3, 5, 6)]
    if name == "committee_uq_packed":
        n_valid = torch.tensor([5], dtype=torch.int32)
        return (lambda p: cuq_kernel.committee_uq_packed(p, 0.1, n_valid)), \
            [_rand(3, 5, 6)]
    raise KeyError(name)


WRAPPERS = ["flash_attention", "wkv6", "ssd", "committee_uq",
            "committee_uq_packed"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_refuses_grad_before_any_device_check(name):
    fn, xs = _inputs(name)
    for i in range(len(xs)):
        args = [x.clone().requires_grad_(j == i) for j, x in enumerate(xs)]
        with pytest.raises(RuntimeError, match=GUARD):
            fn(*args)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_refuses_grad_under_torch_func_grad(name):
    fn, xs = _inputs(name)

    def loss(x0):
        out = fn(x0, *xs[1:])
        return (out[0] if isinstance(out, tuple) else out).float().sum()

    with pytest.raises(RuntimeError, match=GUARD):
        torch.func.grad(loss)(xs[0])


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_guard_passes_without_grad(name):
    """No grad mode, or no input that requires grad: the call goes on to
    its device check (the CPU tensors are refused there, not by the
    guard)."""
    fn, xs = _inputs(name)
    with pytest.raises((RuntimeError, ValueError), match=DEVICE_CHECK):
        fn(*xs)
    with torch.no_grad(), pytest.raises((RuntimeError, ValueError),
                                        match=DEVICE_CHECK):
        fn(*[x.clone().requires_grad_() for x in xs])


def _grad_ok(out_fn, xs):
    xs = [x.clone().requires_grad_() for x in xs]
    out = out_fn(*xs)
    out.sum().backward()
    for x in xs:
        assert x.grad is not None and torch.isfinite(x.grad).all()
        assert float(x.grad.abs().sum()) > 0


def test_ops_on_cpu_stay_differentiable_through_the_plain_versions():
    _, (q, k, v) = _inputs("flash_attention")
    _grad_ok(lambda q, k, v: ops.attention(q, k, v), [q, k, v])
    _, (r, k, v, w, u) = _inputs("wkv6")
    _grad_ok(lambda r, k, v, w, u: ops.wkv6(r, k, v, w, u, chunk=8)[0],
             [r, k, v, w, u])
    _, (x, a, b, c) = _inputs("ssd")
    _grad_ok(lambda x, a, b, c: ops.ssd(x, a, b, c, chunk=8)[0],
             [x, a, b, c])
    _, (p,) = _inputs("committee_uq")
    _grad_ok(lambda p: ops.committee_uq(p, 0.1)[0], [p])
