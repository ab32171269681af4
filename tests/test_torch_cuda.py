"""The port on an NVIDIA card: the Threefry kernel against its plain PyTorch
version, and the slice against the jax-free host engine. Marked `cuda`; each
test skips without a card. On a card machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`tests/conftest.py` imports jax). This file imports none of it.
Tolerances: uniforms bit-exact; normals f32 atol=rtol=2e-6, f64
atol=rtol=1e-13; workload results rtol=1e-4.
"""

import io
import re

import pytest
import torch

pytestmark = pytest.mark.cuda

KEY = (0x01234567, 0x89ABCDEF)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("ctr", [0, (0xFFFFFFFE, 1)])
@pytest.mark.parametrize("n", [1, 2, 3, 1023, 65537])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["rand", "randn"])
def test_kernel_matches_plain(card, kind, dtype, n, ctr):
    from runmat_tpu_torch.ops import threefry
    before = threefry.launches
    got = threefry.rng_draw(kind, KEY, ctr, n, dtype, card)
    want = threefry.plain_draw(kind, KEY, ctr, n, dtype, card)
    torch.cuda.synchronize()
    assert threefry.launches == before + 1
    assert got.is_cuda and got.dtype == dtype and got.shape == (n,)
    if kind == "rand":
        assert torch.equal(got, want)
    else:
        tol = 2e-6 if dtype == torch.float32 else 1e-13
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,pre,label,var", [
    ("elementwise_math", "points = 100000;", "CHECK", "checksum"),
    ("monte_carlo", "M = 65536; T = 16;", "PRICE", "price"),
    ("image_normalize", "B = 8; H = 64; W = 96;", "MSE", "mse")])
def test_workload_on_card_matches_host(card, name, pre, label, var):
    import runmat_tpu_torch
    from runmat_tpu import accel
    from runmat_tpu.session import Session
    from runmat_tpu_torch.ops import threefry

    src = pre + "\n" + open(f"benchmarks/{name}.m").read()
    prev = accel.active_engine()
    accel.set_engine(None)
    host = Session(accelerate=False, stdout=io.StringIO())
    host.run_source(src)
    try:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        before = threefry.launches
        r = s.execute(src)
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    assert r.error is None, r.error
    assert re.search(rf"RESULT_ok {label}=", r.output)
    want = float(host.get(var).host().reshape(-1)[0])
    got = float(s.get(var).host().reshape(-1)[0])
    assert abs(got - want) <= 1e-4 * abs(want)
    assert eng.stats["host_fallbacks"] == 0
    if name == "monte_carlo":
        assert eng.stats["loop_folds"] == 1
        assert threefry.launches - before == 16
    if name == "image_normalize":
        assert threefry.launches - before == 1
