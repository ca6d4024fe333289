"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode), is
marked ``cuda`` and skips without one.  The file imports no JAX, so it
runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import make_estimator, make_system
from repro_torch.core.lut import build_sigmoid_lut
from repro_torch.data.synthetic import make_linear_dataset
from repro_torch.kernels import dispatch
from repro_torch.kernels.lut_activation import (lut_sigmoid_cuda,
                                                lut_sigmoid_plain)
from repro_torch.kernels.quant_matmul import fx_matvec_cuda, fx_matvec_plain

pytestmark = pytest.mark.cuda

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ints(rng, shape, lo=INT32_MIN, hi=INT32_MAX):
    return torch.from_numpy(rng.randint(lo, hi, size=shape, dtype=np.int64)
                            .astype(np.int32))


@pytest.mark.parametrize("shape,f", [((2048, 3072), 16), ((7, 143), 13),
                                     ((1025,), 4), ((3,), 1), ((5, 9), 33)])
@pytest.mark.parametrize("frac_bits", [10, 0])
def test_fx_matvec_kernel_equals_plain(cuda, shape, f, frac_bits):
    rng = np.random.RandomState(f)
    x, w = _ints(rng, (*shape, f)), _ints(rng, f)   # products wrap int32
    out = fx_matvec_cuda(x.to(cuda), w.to(cuda), frac_bits)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), fx_matvec_plain(x, w, frac_bits))


def test_fx_matvec_unaligned_rows_take_the_scalar_path(cuda):
    rng = np.random.RandomState(1)
    flat, w = _ints(rng, 1000 * 16 + 1), _ints(rng, 16)
    x = flat[1:].reshape(1000, 16)            # starts 4 B past an alignment
    xs = flat.to(cuda)[1:].reshape(1000, 16)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    out = fx_matvec_cuda(xs, w.to(cuda), 10)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), fx_matvec_plain(x, w, 10))


@pytest.mark.parametrize("placement", ["wram", "mram"])
@pytest.mark.parametrize("shape", [(2048, 3072), (257, 129), (1,)])
def test_lut_sigmoid_kernel_equals_plain(cuda, placement, shape):
    rng = np.random.RandomState(5)
    edges = np.array([0, 1, -1, 20479, -20479, 20480, -20480, INT32_MAX,
                      INT32_MIN, INT32_MIN + 1], np.int32)
    q = np.concatenate([edges, rng.randint(-30000, 30000, int(np.prod(shape)))
                        .astype(np.int32)])[:int(np.prod(shape))]
    q = torch.from_numpy(q.reshape(shape))
    out = lut_sigmoid_cuda(q.to(cuda), build_sigmoid_lut(device=cuda),
                           placement)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), lut_sigmoid_plain(q, build_sigmoid_lut()))


@pytest.mark.parametrize("workload,version", [("linreg", "int32"),
                                              ("logreg", "int32_lut_mram"),
                                              ("logreg", "int32_lut_wram"),
                                              ("logreg", "bui_lut")])
def test_fit_on_the_card_equals_the_cpu_fit(cuda, workload, version):
    X, y, _ = make_linear_dataset(4096, 16, seed=0)
    fits = {}
    dispatch.reset_launch_counts()
    for device in ("cuda", "cpu"):
        system = make_system("pim", n_cores=16, device=device)
        est = make_estimator(workload, version=version, n_iters=5,
                             system=system).fit(X, y)
        fits[device] = (est.coef_, est.intercept_, system.stats)
    np.testing.assert_array_equal(fits["cuda"][0], fits["cpu"][0])
    assert fits["cuda"][1:] == fits["cpu"][1:]
    expected = {"fx_matvec": 5 * ("int32" in version),
                "lut_sigmoid": 5 * ("lut" in version)}
    assert dispatch.launch_counts == {k: v for k, v in expected.items() if v}
