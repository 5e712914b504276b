"""The port's two-phase sampler (``sampling/two_phase.py``) against the JAX
package's ``TwoPhaseSampler`` and against the port's own single-phase
sampler, on the CPU.

* ``_device_unpack_state`` inverts ``_pack_outputs`` exactly and equals the
  JAX package's unpacking;
* scripted logits (one action 30 above the rest, so both RNGs pick it):
  the continuation of the same carried rows, and ``sample_many`` end to end
  with a cap that strands rows, pack the same bytes as the JAX package's
  (ll within 1e-6);
* a real tiny GGNN: every row that finishes in phase 1 is byte-equal to
  the single-phase sampler's row for the same generator; every straggler
  completes;
* a generate job with ``gen_two_phase_rounds`` writes the files of one
  without, in windows of 4 batches.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from graphinvent_tpu.config import test_config as jax_tiny
from graphinvent_tpu.sampling import two_phase as jtp

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.main import main as port_main
from graphinvent_tpu_torch.sampling import GraphSampler
from graphinvent_tpu_torch.sampling import two_phase as ptp
from graphinvent_tpu_torch.sampling.generator import (
    _pack_outputs, _packed_rounds, batch_generator,
)
from graphinvent_tpu_torch.utils import weights
from graphinvent_tpu_torch.utils.weights import save_checkpoint
from _torch_port_util import bias_head, jax_init
from test_torch_port_sampler import ScriptedLogits, _ll_columns

CPU = torch.device("cpu")


def _cfgs(**kw):
    return jax_tiny("GGNN", **kw), port_tiny("GGNN", device="cpu", **kw)


def _assert_same_packed(got, want, cfg):
    assert got.shape == want.shape and got.dtype == want.dtype
    cols = np.ones(want.shape[1], bool)
    ll = _ll_columns(cfg)
    cols[ll] = False
    np.testing.assert_array_equal(got[:, cols], want[:, cols])
    np.testing.assert_allclose(
        np.ascontiguousarray(got[:, ll]).view(np.float32),
        np.ascontiguousarray(want[:, ll]).view(np.float32), atol=1e-6)


def test_device_unpack_state_inverts_the_packing_like_jax():
    jcfg, pcfg = _cfgs()
    B, N = 12, pcfg.max_n_nodes
    Fn, E, L = pcfg.n_node_features, pcfg.n_edge_features, 26
    rng = np.random.default_rng(4)
    state = dict(
        nodes=(rng.random((B, N, Fn)) < 0.3).astype(np.uint8),
        edges=(rng.random((B, N, N, E)) < 0.15).astype(np.uint8),
        n_nodes=rng.integers(0, N + 1, B), ll=rng.normal(size=(B, L)
                                                         ).astype(np.float32),
        acts=rng.integers(0, 60000, (B, L)),
        term=rng.integers(0, 2, B).astype(np.uint8),
        done=rng.integers(0, 2, B).astype(np.uint8),
        t=rng.integers(0, 700, B))
    order = ("nodes", "edges", "n_nodes", "ll", "acts", "term", "done", "t")
    packed = _pack_outputs(*(torch.from_numpy(state[k]) for k in order), 9)
    assert ptp._row_layout(pcfg) == jtp._row_layout(jcfg)
    assert packed.shape[1] == ptp._row_layout(pcfg)["row_bytes"]
    got = ptp._device_unpack_state(pcfg, packed)
    want = jtp._device_unpack_state(jcfg, jnp.asarray(packed.numpy()))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(v.numpy(), state[k].astype(
            v.numpy().dtype), err_msg=k)


def test_scripted_continuation_packs_the_same_bytes_as_jax():
    jcfg, pcfg = _cfgs(gen_max_actions=12)
    B, R = 24, 3
    script = ScriptedLogits(jcfg, B, seed=2)
    jax_tp = jtp.TwoPhaseSampler(jcfg, B, R, apply_fn=script.jax)
    phase1 = np.asarray(jax_tp._p1({}, jax.random.PRNGKey(0)))
    done = jtp._row_layout(jcfg)["done"][0]
    assert 0 < (phase1[:, done] == 0).sum() < B
    want = np.asarray(jax_tp._cont({}, jax.random.PRNGKey(1),
                                   jnp.asarray(phase1)))
    port_tp = ptp.TwoPhaseSampler(pcfg, B, R, apply_fn=script.torch,
                                  device=CPU)
    got = port_tp.sample_packed(
        {}, batch_generator(0, 0, CPU),
        init_state=ptp._device_unpack_state(pcfg, torch.from_numpy(phase1)))
    _assert_same_packed(got, want, jcfg)
    assert _packed_rounds(pcfg, got) > 1 and (got[:, done] == 1).all()
    # phase 1 itself
    p1 = port_tp.sample_packed({}, batch_generator(0, 0, CPU), stop_round=R)
    _assert_same_packed(p1, phase1, jcfg)
    assert _packed_rounds(pcfg, p1) == R


def test_scripted_sample_many_equals_jax():
    jcfg, pcfg = _cfgs(gen_max_actions=12)
    B, R, n = 8, 3, 3
    script = ScriptedLogits(jcfg, B, seed=5)
    want, wstats = jtp.TwoPhaseSampler(jcfg, B, R, apply_fn=script.jax
                                       ).sample_many({}, jax.random.PRNGKey(2),
                                                     n)
    got, stats = ptp.TwoPhaseSampler(pcfg, B, R, apply_fn=script.torch,
                                     device=CPU).sample_many(
        {}, ptp.window_generator(0, 0, n, CPU), n)
    for k in ("n_stragglers", "n_continuation"):
        assert stats[k] == wstats[k], k
    assert stats["n_stragglers"] > B and stats["n_continuation"] >= 2
    assert stats["rounds"] > n * R
    for g, w in zip(got, want):
        assert g.n_rounds == w.n_rounds == R
        for field in ("t_counts", "actions", "properly_terminated", "done"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field), err_msg=field)
        np.testing.assert_allclose(g.final_loglikelihoods,
                                   w.final_loglikelihoods, atol=1e-5)
        for a, b in zip(g.graphs, w.graphs):
            assert a.n_nodes == b.n_nodes
            np.testing.assert_array_equal(a.edge_features, b.edge_features)
        assert (g.done == 1).all()


def _model(pcfg, seed=1):
    jcfg = jax_tiny("GGNN")
    params = jax_init(jcfg, seed)
    return weights.model_from_jax_params(pcfg, bias_head(jcfg, params))


def test_phase1_rows_are_byte_equal_to_the_single_phase_sampler():
    _, pcfg = _cfgs()
    model = _model(pcfg)
    B, R = 32, 3
    tp = ptp.TwoPhaseSampler(pcfg, B, R, device=CPU)
    off = ptp._row_layout(pcfg)
    raw = tp.sample_packed(model, batch_generator(4, 0, CPU), stop_round=R)
    finished = raw[:, off["done"][0]] == 1
    assert 0 < finished.sum() < B
    (res,), stats = tp.sample_many(model, ptp.window_generator(4, 0, 1, CPU),
                                   1)
    assert stats["n_stragglers"] == B - finished.sum()
    single = GraphSampler(pcfg, B, device=CPU)
    ref_packed = single.sample_packed(model, batch_generator(4, 0, CPU))
    ref = single._decode_packed(ref_packed, 0.0, True)
    # byte-equal rows, all but the batch-wide rounds field
    r0 = off["rounds"][0]
    np.testing.assert_array_equal(raw[finished, :r0],
                                  ref_packed[finished, :r0])
    for i in np.nonzero(finished)[0]:
        assert res.t_counts[i] == ref.t_counts[i]
        np.testing.assert_array_equal(res.actions[i], ref.actions[i])
        assert res.final_loglikelihoods[i] == ref.final_loglikelihoods[i]
        np.testing.assert_array_equal(res.graphs[i].edge_features,
                                      ref.graphs[i].edge_features)
    assert (res.done == 1).all() and res.t_counts.max() > R


def test_generate_job_with_two_phase_writes_its_files(tmp_path):
    job = str(tmp_path / "job")
    os.makedirs(job)
    cfg = port_tiny("GGNN", device="cpu", job_type="generate",
                    job_dir=job + "/", dataset_dir=job + "/", n_samples=40,
                    batch_size=8, generation_epoch=1, tensorboard_dir="",
                    gen_two_phase_rounds=2)
    cfg.write_csv(os.path.join(job, "input.csv"))
    save_checkpoint(_model(cfg, seed=3), job, 1)
    wf = port_main(["--job-dir", job])
    assert len(wf.two_phase_stats) == 2          # windows of 4 and of 1
    assert sum(s["n_stragglers"] for s in wf.two_phase_stats) > 0
    assert [r for r, _ in wf.batch_stats] == [2] * 5
    for k in range(5):
        base = os.path.join(job, "generation", f"epoch_1_gen{k}")
        smiles = open(base + ".smi").read().splitlines()[1:]
        valid = np.loadtxt(base + ".valid", dtype=int)
        ll = np.loadtxt(base + ".likelihood")
        assert len(smiles) == len(valid) == len(ll) == 8
        assert np.isfinite(ll).all() and (ll <= 0).all()
    assert os.path.exists(os.path.join(job, "generation.log"))
