"""Three ``end2end_jsrt`` engine iterations with DeepLabV3 (layers
1-1-1-1, 32^2, the Dice loss) and the min-max post-process against the JAX
package's engine, every draw injected, the ASPP dropout masks included:
the harness and the case are in ``tests/test_torch_isic.py`` (the uint8
chain's case in ``tests/test_torch_deeplab_engine.py``)."""
import pytest

from tests.test_torch_isic import engine_iterations_against_jax


@pytest.mark.parametrize("case", ["jsrt_deeplab_minmax"])
def test_three_iterations_match_jax(case, tmp_path, monkeypatch):
    engine_iterations_against_jax(case, tmp_path, monkeypatch)
