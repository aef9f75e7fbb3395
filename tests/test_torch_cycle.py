"""The cycle-warp variants the published training flags leave off, the port
against the JAX package on the CPU at f32, at tests/test_train_variants.py's
size, with tests/test_torch_train_configs.py's checks and tolerances (two
train steps' losses at rel 2e-3 / 2e-2, equal loss-key sets, spectral u/v
at 2e-5, the train-mode correspondence outputs at atol 5e-4):

- the patch cycle: deepfashion's flags plus --warp_cycle_w 0.1 (the folded
  warp cut back into 4 x 4 patches, warped to the exemplar at D 48);
- the cycle mask with --two_cycle on ade20k (test_train_variants.py's
  test_cycle_mask_and_two_cycle): the label map warped to the exemplar and
  back, the warp's cycle, and the real image to the exemplar and back.

match_kernel 1 with --warp_cycle_w is in tests/test_torch_train_mk1.py."""

import pytest

from test_torch_threads import torch_threads  # noqa: F401
from test_torch_train_configs import (CORR_KEYS, PUBLISHED, check_corr,
                                      check_losses, check_spectral, run_pair)

ADE20K = dict(dataset_mode="ade20k", label_nc=5, contain_dontcare_label=True,
              maskmix=True)
VARIANTS = {
    "patch cycle": dict(PUBLISHED["deepfashion"], warp_cycle_w=0.1),
    "cycle mask, two_cycle": dict(ADE20K, warp_mask_losstype="cycle",
                                  weight_mask=10.0, warp_cycle_w=1.0,
                                  two_cycle=True),
}
# the shift9 core's calls over two steps (forward, backward, attend_corr's
# forward, backward): the row warp and each column warp, twice
CALLS = {
    "patch cycle": (4, 4, 0, 0),
    # row, column of the labels, row back, column of the warp, column of
    # the real image, row back
    "cycle mask, two_cycle": (12, 12, 0, 0),
}


@pytest.fixture(scope="module")
def variants():
    return {v: run_pair(kw) for v, kw in VARIANTS.items()}


@pytest.mark.parametrize("step,tol", [(0, 2e-3), (1, 2e-2)])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_losses_match_jax(variants, variant, step, tol):
    check_losses(variants[variant], "default", step, tol)


@pytest.mark.parametrize("net", ["gen", "corr", "disc"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_spectral_state_matches_jax(variants, variant, net):
    check_spectral(variants[variant], "default", net)


@pytest.mark.parametrize("key", CORR_KEYS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_mode_correspondence_matches_jax(variants, variant, key):
    check_corr(variants[variant], key)


def test_each_variant_makes_its_cycle_outputs(variants):
    """warp_cycle everywhere, the cycle mask and the two-cycle pair only
    where their flags ask for them, and the cycle loss in every step."""
    made = {v: set(res["port_corr"]) for v, res in variants.items()}
    assert made["patch cycle"] == {"warp_out", "warp_cycle"}
    assert made["cycle mask, two_cycle"] == set(CORR_KEYS)
    assert all("G_warp_cycle" in res["jax"][0] for res in variants.values())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_calls(variants, variant):
    assert variants[variant]["default"][2] == CALLS[variant]
