"""Tests that need an NVIDIA GPU: the full-budget operating-point gates, the
large-size smokes and the on-card oracle comparisons, through the same check
functions as chip_smoke.py.

Run on the card with
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
Elsewhere every test here skips: the `gpu` fixture (tests/conftest.py)
decides at run time whether a card is present.
"""
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_operating_point_bands_gaussian_wheel(gpu):
    """Full-budget 512² Gaussian band, published configuration (w pinned —
    run_Gaussian_demo.m:42-43), wheel.png at BSNR 30: σ² within 8%, θ in
    the cross-image band, ≥4 dB gain."""
    chip_smoke.band_gate("gaussian")


def test_operating_point_bands_laplace_wheel(gpu):
    """Full-budget 512² Laplace band: b_EB within ±0.08 of truth, σ² within
    6%, ≥4 dB gain."""
    chip_smoke.band_gate("laplace")


def test_operating_point_bands_moffat_wheel(gpu):
    """Full-budget 512² Moffat band: α within 0.06 of truth, σ² within 8%,
    ≥4 dB gain; β (the weakly identified axis) is not gated."""
    chip_smoke.band_gate("moffat")


def test_operating_point_2048_smoke(gpu):
    chip_smoke.size_smoke(2048)


def test_operating_point_4096_smoke(gpu):
    chip_smoke.size_smoke(4096)


def test_oracles_on_card(gpu):
    """The prox at 512², SALSA at 256² and five SAPG steps at 512² in f32 on
    the card against the f64 oracles (and the SAPG steps against the CPU)."""
    import jax

    card, cpu = jax.devices()[0], jax.devices("cpu")[0]
    chip_smoke.check_prox(512, card)
    chip_smoke.check_salsa(256, card)
    chip_smoke.check_sapg(512, 5, card, cpu)
