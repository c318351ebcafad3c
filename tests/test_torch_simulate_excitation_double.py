"""The port's bowed and hammered float64 dataset-generation runs against
the JAX package's: ``tests/test_torch_simulate_excitation.py``'s float64
check (``check_double``) on the batches it leaves to this file, so that
the two files' runs share out the minutes of the eager engine.
"""

import pytest

from test_torch_simulate_excitation import check_double


@pytest.mark.parametrize("model_name", ["bow", "hammer"])
def test_simulate_excitation_double_matches_jax(tmp_path, model_name):
    check_double(tmp_path, model_name)
