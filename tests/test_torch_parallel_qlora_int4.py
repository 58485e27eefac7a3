"""QLoRA on the Q4_0 and w4x8 bases on a mesh of the port's ranks against
the JAX package's meshed `lora_train_step`: the checks of
tests/test_torch_parallel_lora.py (which holds Q8_0, perplexity and the
merge) at tp 2, dp 2 and sp 2. JAX's w4x8 kernel runs outside interpret
mode (the steps' rows are above 16, where it is the exact dequantized
product)."""

import pytest

from test_torch_parallel_lora import MESH_IDS, MESHES, check_init_lora, check_lora_step, run_meshed

KINDS = ("q4_0", "w4x8")


@pytest.fixture(scope="module", params=MESHES, ids=MESH_IDS)
def meshed(request, tmp_path_factory):
    return run_meshed(request.param, tmp_path_factory, KINDS, with_ppl=False)


@pytest.mark.parametrize("kind", KINDS)
def test_lora_train_step_matches_jax_meshed(meshed, kind):
    check_lora_step(meshed, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_init_lora_under_tp_cuts_one_cards_draw(meshed, kind):
    check_init_lora(meshed, kind)
