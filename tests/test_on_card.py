"""chip_smoke's one-card phases on the card itself, at a cut catalog.

Marked ``gpu``: it skips on any other device. Run it on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu -n0 tests/``.
"""

import pytest


@pytest.fixture
def card():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev


@pytest.mark.gpu
def test_smoke_phases_on_card(card):
    import chip_smoke as cs

    out = cs.run_one_card(cs.Sizes(tracks=64), card=card.device_kind)
    assert out["recognize"]["clean"] == 1.0
    assert out["serve"]["errors"] == 0
