"""The port's loss functions against ``graphinvent_tpu.train.loss`` on the
same seeded inputs.

Tolerance: atol 1e-6 (f32 log-softmax and row sums over <= 600 columns in
another summation order), values and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphinvent_tpu.train import loss as jloss

from graphinvent_tpu_torch.train import loss as ploss

ATOL = 1e-6


def _inputs(seed, B=12, A=40, zero_rows=(3, 7)):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, A)) * 3).astype(np.float32)
    # sparse non-negative counts, some rows with several correct actions
    targets = (rng.random((B, A)) < 0.08).astype(np.float32) * rng.integers(
        1, 4, size=(B, A)).astype(np.float32)
    targets[np.arange(B), rng.integers(0, A, B)] += 1.0
    for r in zero_rows:
        targets[r] = 0.0
    valid = np.ones(B, np.float32)
    for r in zero_rows:
        valid[r] = 0.0
    return logits, targets, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_apd_kl_loss_matches_jax(seed, masked):
    logits, targets, valid = _inputs(seed)
    v = valid if masked else None
    want = float(jloss.apd_kl_loss(jnp.asarray(logits), jnp.asarray(targets),
                                   None if v is None else jnp.asarray(v)))
    got = ploss.apd_kl_loss(torch.from_numpy(logits),
                            torch.from_numpy(targets),
                            None if v is None else torch.from_numpy(v))
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= ATOL


@pytest.mark.parametrize("masked", [False, True])
def test_apd_kl_loss_gradient_matches_jax_and_is_finite(masked):
    """All-zero target rows are where ``0 * inf`` would appear in the
    backward without the clamp inside the log."""
    logits, targets, valid = _inputs(2)
    v = valid if masked else None
    want = np.asarray(jax.grad(jloss.apd_kl_loss)(
        jnp.asarray(logits), jnp.asarray(targets),
        None if v is None else jnp.asarray(v)))
    x = torch.from_numpy(logits).requires_grad_(True)
    ploss.apd_kl_loss(x, torch.from_numpy(targets),
                      None if v is None else torch.from_numpy(v)).backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=ATOL, rtol=0)
    assert (x.grad[[3, 7]] == 0).all()


def test_apd_kl_loss_all_rows_masked_is_zero():
    logits, targets, _ = _inputs(3)
    zeros = np.zeros(len(logits), np.float32)
    got = ploss.apd_kl_loss(torch.from_numpy(logits),
                            torch.from_numpy(targets),
                            torch.from_numpy(zeros))
    want = float(jloss.apd_kl_loss(jnp.asarray(logits), jnp.asarray(targets),
                                   jnp.asarray(zeros)))
    assert got.item() == want == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_correct_action_likelihoods_match_jax(seed):
    logits, targets, _ = _inputs(seed)
    want = np.asarray(jloss.correct_action_likelihoods(
        jnp.asarray(logits), jnp.asarray(targets)))
    got = ploss.correct_action_likelihoods(torch.from_numpy(logits),
                                           torch.from_numpy(targets)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got[[3, 7]] == 0).all()          # all-zero rows: no mass, no NaN
    assert ((got >= 0) & (got <= 1 + ATOL)).all()
