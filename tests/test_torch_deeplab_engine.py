"""Three ``end2end_jsrt`` engine iterations with DeepLabV3 (layers
1-1-1-1, 32^2, the Dice loss) against the JAX package's engine, every draw
injected, the ASPP dropout masks included, with the preset's uint8 chain
and with the min-max post-process: the harness and the cases are in
``tests/test_torch_isic.py``."""
import pytest

from tests.test_torch_isic import engine_iterations_against_jax


@pytest.mark.parametrize("case", ["jsrt_deeplab", "jsrt_deeplab_minmax"])
def test_three_iterations_match_jax(case, tmp_path, monkeypatch):
    engine_iterations_against_jax(case, tmp_path, monkeypatch)
