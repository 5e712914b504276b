"""The port's training path (dropout, wire formats, train/eval/NLL steps,
device-resident epochs, checkpoints) against ``graphinvent_tpu.train`` on
the same seeded inputs and bridged weights, in float32 on the CPU.

Tolerances: a 20-step loss trajectory rtol 1e-4 (f32 forward and backward
through two or three message passes in another summation order, fed back
through Adam); gradients at step 0 rtol 1e-4 plus atol 1e-6; epoch losses
rtol 1e-4; per-row NLLs rtol 1e-4 plus atol 1e-5.  On the JAX side the
Pallas kernel is not reached on the CPU (its gate turns itself off), so
grad-free forwards there take the plain XLA path.
"""

import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphinvent_tpu.config import preset as jax_preset
from graphinvent_tpu.config import test_config as jax_tiny
from graphinvent_tpu.data.loader import HDFDataset as JaxHDFDataset
from graphinvent_tpu.models import apply_model, init_model
from graphinvent_tpu.models import core as jcore
from graphinvent_tpu.train import device_data as jdd
from graphinvent_tpu.train import step as jstep
from graphinvent_tpu.train.loss import apd_kl_loss as jax_kl
from graphinvent_tpu.train.optim import adam_init
from graphinvent_tpu.train.optim import onecycle_for_config as jax_onecycle
from graphinvent_tpu.utils import checkpoint as jckpt
from graphinvent_tpu.workflow import streamed_random_nlls as jax_streamed_nlls

from graphinvent_tpu_torch import workflow as pworkflow
from graphinvent_tpu_torch.config import preset as port_preset
from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.data import store
from graphinvent_tpu_torch.data.loader import (
    HDFDataset, pack_rows, sparse_apds,
)
from graphinvent_tpu_torch.models import build_model, core, fused_enn
from graphinvent_tpu_torch.sampling.generator import (
    batch_generator, seeded_generator,
)
from graphinvent_tpu_torch.train import device_data as pdd
from graphinvent_tpu_torch.train import step as pstep
from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
from graphinvent_tpu_torch.utils import weights
from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs

CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, B, seed, n_pad=0):
    """Seeded graphs with sparse count targets; the last ``n_pad`` rows are
    padding (zeros, valid = 0)."""
    nodes, edges = synthetic_graphs(cfg, B, seed=seed)
    rng = np.random.default_rng(seed)
    apds = np.zeros((B, cfg.dim_apd), np.float32)
    apds[np.arange(B), rng.integers(0, cfg.dim_apd, B)] = 1
    apds[::3, rng.integers(0, cfg.dim_apd)] += 2
    valid = np.ones(B, np.float32)
    if n_pad:
        nodes[-n_pad:], edges[-n_pad:], apds[-n_pad:] = 0, 0, 0
        valid[-n_pad:] = 0
    return {"nodes": nodes, "edges": edges, "apds": apds, "valid": valid}


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _pair(name="tiny", seed=7, **kw):
    """(JAX cfg, JAX params, port cfg, port model) on the same weights."""
    if name == "tiny":
        jcfg, pcfg = jax_tiny("GGNN", **kw), port_tiny("GGNN", device="cpu",
                                                       **kw)
    else:
        kw = dict(compute_dtype="float32", **kw)
        jcfg = jax_preset("GGNN", **kw)
        pcfg = port_preset("GGNN", device="cpu", **kw)
    params = init_model(jcfg, jax.random.PRNGKey(seed))
    model = weights.ggnn_from_jax_params(pcfg, _np_tree(params))
    return jcfg, params, pcfg, model


# --------------------------------------------------------------------------
# dropout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5])
def test_alpha_dropout_equals_the_jax_formula_under_a_shared_mask(p):
    x = np.random.default_rng(0).normal(size=(64, 33)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - p, x.shape))
    want = np.asarray(jcore.alpha_dropout(key, jnp.asarray(x), p))
    got = core.alpha_dropout_masked(torch.from_numpy(x),
                                    torch.from_numpy(keep.copy()), p).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_alpha_dropout_is_reproducible_from_its_generator():
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(200, 50)).astype(np.float32))
    a = core.alpha_dropout(x, 0.2, seeded_generator([5, 1], CPU))
    b = core.alpha_dropout(x, 0.2, seeded_generator([5, 1], CPU))
    c = core.alpha_dropout(x, 0.2, seeded_generator([5, 2], CPU))
    assert torch.equal(a, b) and not torch.equal(a, c)
    dropped = (a != core.alpha_dropout_masked(
        x, torch.ones_like(x, dtype=torch.bool), 0.2))
    assert abs(dropped.float().mean().item() - 0.2) < 0.02
    assert core.alpha_dropout(x, 0.0, seeded_generator([5], CPU)) is x
    # the global RNG is not touched
    state = torch.get_rng_state()
    core.alpha_dropout(x, 0.2, seeded_generator([5, 1], CPU))
    assert torch.equal(torch.get_rng_state(), state)


def test_model_dropout_needs_train_and_a_generator():
    kw = dict(enn_dropout_p=0.3, mlp1_dropout_p=0.3, mlp2_dropout_p=0.3,
              gather_att_dropout_p=0.3, gather_emb_dropout_p=0.3)
    cfg = port_tiny("GGNN", device="cpu", **kw)
    model = build_model(cfg, torch.Generator().manual_seed(0))
    b = _tensors(_batch(cfg, 6, 0))
    # grad stays on, so every forward here takes core (not the fused path)
    def run(**kw):
        return model(b["nodes"], b["edges"], **kw).detach()
    plain = run(train=False, generator=seeded_generator([1], CPU))
    # as in the JAX package: no key, no dropout
    assert torch.equal(run(train=True), plain)
    d1 = run(train=True, generator=seeded_generator([1], CPU))
    d2 = run(train=True, generator=seeded_generator([1], CPU))
    d3 = run(train=True, generator=seeded_generator([2], CPU))
    assert torch.equal(d1, d2)
    assert not torch.equal(d1, plain) and not torch.equal(d1, d3)


# --------------------------------------------------------------------------
# wire formats
# --------------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 7, 8, 104, 507])
def test_unpackbits_is_byte_equal_to_numpy(count):
    rng = np.random.default_rng(count)
    packed = rng.integers(0, 256, (9, (count + 7) // 8)).astype(np.uint8)
    got = pstep.unpackbits(torch.from_numpy(packed), count)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.unpackbits(packed, axis=1, count=count))
    with pytest.raises(TypeError):
        pstep.unpackbits(torch.from_numpy(packed.astype(np.int32)), count)


def test_batch_arrays_of_all_three_wires_are_equal_and_match_jax():
    jcfg, pcfg = jax_tiny("GGNN"), port_tiny("GGNN", device="cpu")
    plain = _batch(pcfg, 10, 3, n_pad=2)
    int8 = {k: v.astype(np.int8) for k, v in plain.items() if k != "valid"}
    packed = {"nodes_p": pack_rows(int8["nodes"]),
              "edges_p": pack_rows(int8["edges"]), "valid": plain["valid"]}
    idx, val = sparse_apds(int8["apds"], 4)
    wires = {
        "plain": plain,
        "packed": dict(packed, apds=int8["apds"]),
        "sparse": dict(packed, apds_i=idx, apds_v=val),
    }
    place = pstep.BatchUploader(CPU)
    want = None
    for name, wire in wires.items():
        got = pstep.batch_arrays(pcfg, place(wire), torch.float32)
        ref = jstep.batch_arrays(
            jcfg, {k: jnp.asarray(v) for k, v in wire.items()}, jnp.float32)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), name)
        assert got[2].dtype == torch.float32
        if want is None:
            want = got
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
    bf = pstep.batch_arrays(pcfg, place(wires["sparse"]), torch.bfloat16)
    assert bf[0].dtype == bf[1].dtype == torch.bfloat16
    assert bf[2].dtype == torch.float32


def test_sparse_indices_above_int16_survive_the_wire():
    idx = np.array([[0, 40000, 65535]], np.uint16)
    t = pstep.as_tensor(idx)
    assert t.dtype == torch.int16
    np.testing.assert_array_equal((t.to(torch.int64) & 0xFFFF).numpy(),
                                  idx.astype(np.int64))


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------

def _jax_loss_and_grads(jcfg, params, batch):
    def loss_fn(p):
        logits = apply_model(jcfg, p, jnp.asarray(batch["nodes"]),
                             jnp.asarray(batch["edges"]), train=True)
        return jax_kl(logits.astype(jnp.float32), jnp.asarray(batch["apds"]),
                      jnp.asarray(batch["valid"]))
    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("name,B", [("tiny", 8), ("preset", 4)])
def test_gradients_at_step_0_match_jax(name, B):
    jcfg, params, pcfg, model = _pair(name)
    batch = _batch(pcfg, B, 5, n_pad=1)
    want_loss, grads = _jax_loss_and_grads(jcfg, params, batch)
    loss = pstep.train_loss(pcfg, model, _tensors(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = weights.state_dict_from_jax_params(pcfg, _np_tree(grads))
    named = dict(model.named_parameters())
    assert sorted(want) == sorted(named)
    for k, g in want.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_20_step_f32_loss_trajectory_matches_make_train_step():
    jcfg, params, pcfg, model = _pair("tiny", epochs=2)
    jsched, psched = jax_onecycle(jcfg, 10), onecycle_for_config(pcfg, 10)
    jtrain = jstep.make_train_step(jcfg, jsched)
    adam = Adam(model)
    ptrain = pstep.make_train_step(pcfg, psched, model, adam)
    opt_state = adam_init(params)
    key = jax.random.PRNGKey(0)
    jlosses, plosses = [], []
    for k in range(20):
        batch = _batch(pcfg, 8, 100 + k, n_pad=k % 3)
        params, opt_state, jl = jtrain(
            params, opt_state, {n: jnp.asarray(v) for n, v in batch.items()},
            key)
        jlosses.append(float(jl))
        plosses.append(ptrain(_tensors(batch)).item())
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    assert adam.step == int(opt_state.step) == 20
    assert plosses[-1] != plosses[0]
    # Adam's moments cross the weight bridge both ways
    state = adam.state_dict()
    for key_, tree in (("mu", opt_state.mu), ("nu", opt_state.nu)):
        want = weights.state_dict_from_jax_params(pcfg, _np_tree(tree))
        for k, v in want.items():
            np.testing.assert_allclose(state[key_][k].numpy(), v.numpy(),
                                       rtol=1e-3, atol=1e-7, err_msg=k)
        back = weights.jax_params_from_state_dict(pcfg, state[key_])
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(_np_tree(tree))):
            assert a.shape == b.shape


def test_eval_and_nll_steps_match_jax():
    jcfg, params, pcfg, model = _pair("tiny")
    batch = _batch(pcfg, 8, 9, n_pad=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss = float(jstep.make_eval_step(jcfg)(params, jbatch))
    want_nll = np.asarray(jstep.make_likelihood_step(jcfg)(params, jbatch))
    loss = pstep.make_eval_step(pcfg, model)(_tensors(batch))
    nll = pstep.make_likelihood_step(pcfg, model)(_tensors(batch))
    assert not loss.requires_grad and loss.is_inference()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    np.testing.assert_allclose(nll.numpy(), want_nll, rtol=1e-4, atol=1e-5)
    # padded rows: -log(1e-30), finite, dropped by the caller's mask
    assert np.isfinite(nll.numpy()).all()
    np.testing.assert_allclose(nll.numpy()[-2:], -np.log(1e-30), rtol=1e-6)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts calls of the kernel's plain version, which is what the fused
    wrappers run for a CPU tensor."""
    calls = {"n": 0}
    real = fused_enn.fused_stacked_mlp_reference

    def counting(flat, x2d):
        calls["n"] += 1
        return real(flat, x2d)

    monkeypatch.setattr(fused_enn, "fused_stacked_mlp_reference", counting)
    return calls


def test_grad_free_steps_take_the_fused_wrappers_and_training_never_does(
        plain_calls):
    cfg = port_tiny("GGNN", device="cpu")
    model = build_model(cfg, torch.Generator().manual_seed(0))
    adam = Adam(model)
    batch = _tensors(_batch(cfg, 8, 1))
    per_forward = cfg.message_passes + 7
    pstep.make_train_step(cfg, onecycle_for_config(cfg, 4), model, adam)(batch)
    assert plain_calls["n"] == 0
    pstep.make_eval_step(cfg, model)(batch)
    assert plain_calls["n"] == per_forward
    pstep.make_likelihood_step(cfg, model)(batch)
    assert plain_calls["n"] == 2 * per_forward
    # a grad-enabled eval forward keeps core too: the kernel has no backward
    model(batch["nodes"], batch["edges"], train=False)
    assert plain_calls["n"] == 2 * per_forward
    off = cfg.replace(fused_inference_enn=False)
    model.cfg = off
    pstep.make_eval_step(off, model)(batch)
    assert plain_calls["n"] == 2 * per_forward


def test_fused_wrappers_see_the_weights_an_optimizer_step_left(plain_calls):
    """The wrappers cache flattened weights per module, keyed on each
    parameter's data pointer and version.  Adam updates in place: after a
    step, a grad-free forward through the wrappers equals ``core`` on the
    NEW weights (atol 1e-5: f32, another summation order)."""
    cfg = port_tiny("GGNN", device="cpu")
    model = build_model(cfg, torch.Generator().manual_seed(0))
    adam = Adam(model)
    batch = _tensors(_batch(cfg, 8, 2))
    eval_step = pstep.make_eval_step(cfg, model)
    with torch.inference_mode():
        before = model(batch["nodes"], batch["edges"])     # fills the cache
    ptrs = [p.data_ptr() for p in model.parameters()]
    loss = pstep.train_loss(cfg, model, batch)
    loss.backward()
    adam.update(lr=0.05, beta1=0.9)
    assert ptrs == [p.data_ptr() for p in model.parameters()]
    with torch.inference_mode():
        fused = model(batch["nodes"], batch["edges"])
    assert plain_calls["n"] == 2 * (cfg.message_passes + 7)
    with torch.no_grad():
        unfused = model(batch["nodes"], batch["edges"])     # core, new weights
    assert (fused - before).abs().max() > 1e-2
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), atol=1e-5,
                               rtol=1e-5)
    x = torch.randn(5, cfg.hidden_node_features)
    with torch.no_grad():
        np.testing.assert_allclose(
            fused_enn.fused_mlp(model.gather.emb_nn, x).numpy(),
            core.mlp(model.gather.emb_nn, x).numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(
            fused_enn.fused_stacked_mlp(model.msg_nns, x[None]).numpy(),
            core.stacked_mlp(list(model.msg_nns), x[None]).numpy(),
            atol=1e-5, rtol=1e-5)
    assert eval_step(batch).item() > 0


# --------------------------------------------------------------------------
# device-resident epochs
# --------------------------------------------------------------------------

def _dataset(tmp_path, cfg, rows, seed=0):
    b = _batch(cfg, rows, seed)
    path = str(tmp_path / "train.h5")
    store.write_arrays(path, {"nodes": b["nodes"].astype(np.int8),
                              "edges": b["edges"].astype(np.int8),
                              "APDs": b["apds"].astype(np.int8)})
    return path


def test_permutations_match_jax():
    for n, bs in ((37, 8), (16, 8), (5, 8)):
        a = pdd.epoch_permutation(n, bs, np.random.default_rng(3))
        b = jdd.epoch_permutation(n, bs, np.random.default_rng(3))
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        a = pdd.nll_row_batches(n, 20, bs, np.random.default_rng(4))
        b = jdd.nll_row_batches(n, 20, bs, np.random.default_rng(4))
        np.testing.assert_array_equal(a, b)


def test_device_resident_epochs_match_jax(tmp_path):
    jcfg, params, pcfg, model = _pair("tiny", epochs=2)
    path = _dataset(tmp_path, pcfg, 37)
    jds, pds = JaxHDFDataset(path), HDFDataset(path)
    jdata, pdata = jdd.DeviceDataset(jds), pdd.DeviceDataset(pds, CPU)
    assert pdata.nbytes == jdata.nbytes == pdd.DeviceDataset.nbytes_of(pds) \
        == jdd.DeviceDataset.nbytes_of(jds)
    assert pdata.nodes.dtype == pdata.apds.dtype == torch.int8
    n_batches = 5
    jsched = jax_onecycle(jcfg, n_batches)
    psched = onecycle_for_config(pcfg, n_batches)
    adam = Adam(model)
    jtrain = jdd.make_epoch_train_fn(jcfg, jsched, jdata)
    ptrain = pdd.make_epoch_train_fn(pcfg, psched, pdata, model, adam)
    opt_state = adam_init(params)
    rng_j, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    for epoch in range(2):
        perm = pdd.epoch_permutation(37, 8, rng_p)
        np.testing.assert_array_equal(
            perm, jdd.epoch_permutation(37, 8, rng_j))
        params, opt_state, jl = jtrain(params, opt_state, jnp.asarray(perm),
                                       jax.random.PRNGKey(epoch))
        np.testing.assert_allclose(ptrain(perm), float(jl), rtol=1e-4)
    assert adam.step == int(opt_state.step) == 2 * n_batches

    vperm = pdd.epoch_permutation(37, 8, np.random.default_rng(0))
    want = float(jdd.make_epoch_eval_fn(jcfg, jdata)(params,
                                                     jnp.asarray(vperm)))
    got = pdd.make_epoch_eval_fn(pcfg, pdata, model)(vperm)
    np.testing.assert_allclose(got, want, rtol=1e-4)

    nperm = pdd.nll_row_batches(37, 20, 8, np.random.default_rng(1))
    jn, jv = jdd.make_epoch_nll_fn(jcfg, jdata)(params, jnp.asarray(nperm))
    pn, pv = pdd.make_epoch_nll_fn(pcfg, pdata, model)(nperm)
    np.testing.assert_array_equal(pv, np.asarray(jv))
    assert pv.sum() == 20
    np.testing.assert_allclose(pn[pv > 0], np.asarray(jn)[pv > 0],
                               rtol=1e-4, atol=1e-5)
    jds.close()
    pds.close()


def test_gather_batch_masks_padding_and_keeps_int8():
    cfg = port_tiny("GGNN", device="cpu")

    class Data:
        device = CPU
        nodes = torch.arange(5, dtype=torch.int8).reshape(5, 1, 1)
        edges = torch.arange(5, dtype=torch.int8).reshape(5, 1, 1, 1)
        apds = torch.arange(5, dtype=torch.int8).reshape(5, 1)

    b = pdd._gather_batch(Data, torch.tensor([3, -1, 0, 4, -1]))
    assert b["nodes"].dtype == torch.int8
    assert b["apds"][:, 0].tolist() == [3, 0, 0, 4, 0]
    assert b["valid"].tolist() == [1.0, 0.0, 1.0, 1.0, 0.0]
    del cfg


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_checkpoint_and_sidecar_round_trip_and_jax_reads_the_pth(tmp_path):
    jcfg, params, pcfg, model = _pair("tiny")
    adam = Adam(model)
    pstep.make_train_step(pcfg, onecycle_for_config(pcfg, 4), model, adam)(
        _tensors(_batch(pcfg, 8, 0)))
    job = str(tmp_path)
    weights.save_checkpoint(model, job, 3, adam.state_dict())
    weights.save_checkpoint(model, job, 12, adam.state_dict())
    weights.save_checkpoint(model, job, 7)                 # weights only
    assert weights.latest_checkpoint(job) == (
        weights.checkpoint_path(job, 12), 12)
    assert weights.latest_checkpoint(str(tmp_path / "nowhere")) is None
    assert not [n for n in (tmp_path).iterdir() if n.name.endswith(".tmp")]
    # the sidecar's name is invisible to the JAX package's checkpoint scan
    assert jckpt.latest_checkpoint(job) == (
        weights.checkpoint_path(job, 12), 12)
    assert weights.load_optimizer_state(job, 7) is None

    again = weights.load_checkpoint(pcfg, weights.checkpoint_path(job, 12))
    restored = Adam(again)
    restored.load_state_dict(weights.load_optimizer_state(job, 12))
    assert restored.step == adam.step == 1
    for a, b in zip(adam.mu + adam.nu + adam.params,
                    restored.mu + restored.nu + restored.params):
        assert torch.equal(a, b)

    # the JAX package loads the port-written .pth: the trained weights,
    # equal to the reverse bridge's pytree
    loaded = jckpt.load_params_any(jcfg, weights.checkpoint_path(job, 12))
    back = weights.jax_params_from_state_dict(
        pcfg, weights.reference_state_dict(model))
    flat_a, tree_a = jax.tree_util.tree_flatten(_np_tree(loaded))
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b == jax.tree_util.tree_structure(_np_tree(params))
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # and the two bridges are inverses
    sd = weights.state_dict_from_jax_params(pcfg, back)
    for k, v in weights.reference_state_dict(model).items():
        assert torch.equal(sd[k], v), k


# --------------------------------------------------------------------------
# workflow helpers
# --------------------------------------------------------------------------

def test_streamed_random_nlls_match_the_jax_workflow(tmp_path):
    cfg = port_tiny("GGNN", device="cpu")
    path = _dataset(tmp_path, cfg, 53, seed=2)

    def run_nll(batch):
        assert batch["nodes"].shape[0] == 8 and batch["nodes"].dtype == np.float32
        return batch["apds"].sum(axis=1) * 10 + batch["nodes"].sum(axis=(1, 2))

    jds, pds = JaxHDFDataset(path), HDFDataset(path)
    for max_rows in (20, 53, 100):
        want = jax_streamed_nlls(jds, run_nll, max_rows, 8, 16,
                                 np.random.default_rng(6))
        got = pworkflow.streamed_random_nlls(pds, run_nll, max_rows, 8, 16,
                                             np.random.default_rng(6))
        np.testing.assert_array_equal(got, want)
        assert len(got) == min(max_rows, 53)
    jds.close()
    pds.close()


def test_evaluation_generators_never_collide():
    seeds = set()
    for epoch in range(1, 40):
        for k in range(12):
            seeds.add(pworkflow.eval_sample_generator(
                0, epoch, k, CPU).initial_seed())
    assert len(seeds) == 39 * 12
    # nor with the generate job's batches of the same seed
    gen = {batch_generator(0, k, CPU).initial_seed() for k in range(2000)}
    assert len(gen) == 2000 and not (gen & seeds)
    assert pworkflow.eval_sample_generator(0, 5, 1, CPU).initial_seed() != \
        pworkflow.eval_sample_generator(0, 6, 0, CPU).initial_seed()


def test_upload_ahead_keeps_order_and_raises_worker_errors():
    def batches(n, fail_at=None):
        for k in range(n):
            if k == fail_at:
                raise OSError("read failed")
            yield {"k": np.array([k])}

    place = pstep.BatchUploader(CPU)
    got = [int(b["k"][0]) for b in pworkflow.upload_ahead(batches(25), place)]
    assert got == list(range(25))
    seen = []
    with pytest.raises(OSError, match="read failed"):
        for b in pworkflow.upload_ahead(batches(25, fail_at=4), place):
            seen.append(int(b["k"][0]))
    assert seen == [0, 1, 2, 3]

    def bad_place(batch):
        raise ValueError("upload failed")

    with pytest.raises(ValueError, match="upload failed"):
        list(pworkflow.upload_ahead(batches(3), bad_place))


def test_upload_ahead_abandoned_by_its_consumer_stops_its_worker():
    before = threading.active_count()
    slow = queue.Queue()

    def batches():
        for k in range(1000):
            slow.put(k)
            yield {"k": np.array([k])}

    it = pworkflow.upload_ahead(batches(), pstep.BatchUploader(CPU))
    next(it)
    it.close()                      # the consumer walks away mid-epoch
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
    assert slow.qsize() < 10        # the worker did not run the epoch out
