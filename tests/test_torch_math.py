"""The port's CPU exp and log (``repro_torch.kernels._math``), which keep the
SSD and attention plain paths off MKL's vector math (ROADMAP queue 3 (f)):
within 1 ulp of ``torch.exp`` and ``torch.log`` in f32, the limits exact.

The reference values are taken after a one-element ``torch.exp`` and
``torch.log`` on one thread, so that their own first VML call is not the
multi-threaded one that (f) is about.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _math


@pytest.fixture(scope="module", autouse=True)
def vml_warm():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.exp(torch.zeros(1))
    torch.log(torch.ones(1))
    torch.set_num_threads(threads)


def ulps(got, want):
    """Distance in f32 units in the last place between finite f32 tensors of
    one sign (their bit patterns are ordered like their values)."""
    g = got.numpy().view(np.int32).astype(np.int64)
    w = want.numpy().view(np.int32).astype(np.int64)
    return np.abs(g - w)


def test_exp_within_one_ulp_of_torch_exp():
    # Every result a normal f32: exp(-87.3) is about the smallest.
    x = torch.from_numpy(np.linspace(-87.0, 88.0, 200_001, dtype=np.float32))
    got = _math.exp(x)
    assert got.dtype == torch.float32
    assert int(ulps(got, torch.exp(x)).max()) <= 1
    # -inf and large negatives (the masked causal exponents) give exactly 0.
    low = torch.tensor([-torch.inf, -1e30, -1e4, -200.0])
    assert torch.equal(_math.exp(low), torch.zeros(4))
    assert torch.equal(_math.exp(torch.tensor([0.0])), torch.ones(1))


def test_log_within_one_ulp_of_torch_log():
    x = torch.from_numpy(np.geomspace(1e-37, 1e37, 200_001, dtype=np.float32))
    got = _math.log(x)
    want = torch.log(x)
    pos, neg = want > 0, want < 0
    assert int(ulps(got[pos], want[pos]).max()) <= 1
    assert int(ulps(got[neg], want[neg]).max()) <= 1
    assert torch.equal(_math.log(torch.tensor([0.0, 1.0, torch.inf])),
                       torch.tensor([-torch.inf, 0.0, torch.inf]))


def test_exp_differentiates_and_vmaps_like_torch_exp():
    a_log = torch.linspace(-2.0, 2.0, 12).reshape(3, 4).requires_grad_()
    (-_math.exp(a_log)).sum().backward()
    torch.testing.assert_close(a_log.grad, -torch.exp(a_log.detach()), rtol=2e-7, atol=0.0)
    got = torch.func.vmap(_math.exp)(a_log.detach())
    assert int(ulps(got, torch.exp(a_log.detach())).max()) <= 1
