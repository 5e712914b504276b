"""The hand-written CUDA kernel against its plain version, and the training
path's device code (uploads, wire decoding, launch accounting), on the card.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.  Imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerances: f32 1e-4 (summation order over K <= 685 in f32); bf16 1/64
absolute plus 1/64 relative, about two bf16 ulps at |y| ~ 1 (the two
versions sum in another order and may round one layer's value to the
neighbouring bf16 number).
"""

import numpy as np
import pytest
import torch

from graphinvent_tpu_torch.models import fused_enn
from graphinvent_tpu_torch.models.core import MLP

TOL = {torch.float32: 1e-4, torch.bfloat16: 1.0 / 64}

# (name, E, rows, I, hidden, O): the GGNN generate job's launch shapes at
# preset("GGNN"), B=1000, N=13, plus a ragged row count, the ChEMBL-width
# message stack (N=40, four bond types) and a row count below one tile; then
# the EMN's shapes at B=1000 (the AttGGNN's two stacks have the shape of
# "msg_nns"): 96 packed edge slots or 13 x 13 dense ones a graph, and the
# embedding net's 2 * 8 + 3 input features
SHAPES = [
    ("msg_nns", 3, 13000, 100, [250] * 4, 100),
    ("att_nn", 1, 13000, 108, [250] * 4, 100),
    ("emb_nn", 1, 13000, 100, [250] * 4, 100),
    ("f_add_1", 1, 13000, 100, [500] * 4, 45),
    ("f_conn_1", 1, 13000, 100, [500] * 4, 3),
    ("f_add_2", 1, 1000, 685, [500] * 4, 585),
    ("f_conn_2", 1, 1000, 139, [500] * 4, 39),
    ("f_term_2", 1, 1000, 100, [500] * 4, 1),
    ("msg_ragged", 3, 12345, 100, [250] * 4, 100),
    ("msg_chembl", 4, 40000, 100, [250] * 4, 100),
    ("f_add_1_r37", 1, 37, 100, [500] * 4, 45),
    ("emn_embedding", 1, 96000, 19, [250] * 4, 100),
    ("emn_packed", 1, 96000, 100, [250] * 4, 100),
    ("emn_dense", 1, 169000, 100, [250] * 4, 100),
    # the GGNN at ChEMBL-proxy width (N=40, E=4), B=1000
    ("att_nn_n40", 1, 40000, 108, [250] * 4, 100),
    ("f_add_1_n40", 1, 40000, 100, [500] * 4, 60),
    ("f_conn_1_n40", 1, 40000, 100, [500] * 4, 4),
    ("f_add_2_n40", 1, 1000, 2500, [500] * 4, 2400),
    ("f_conn_2_n40", 1, 1000, 260, [500] * 4, 160),
]


def _plans(shape):
    """bf16 runs every shape under both kinds of plan (no cluster, the
    plan's largest cluster); f32 has one kernel and no plan."""
    dims = (shape[3], *shape[4], shape[5])
    plans = fused_enn.plan_choices(dims)
    if shape[0] == "f_add_2":           # the largest cluster the kernel takes
        plans.append(fused_enn.LaunchPlan(64, 8))
    return plans


CASES = [(s, torch.float32, None) for s in SHAPES] + [
    (s, torch.bfloat16, p) for s in SHAPES for p in _plans(s)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _towers(E, I, hidden, O, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.nn.ModuleList(MLP(I, hidden, O, generator=g)
                               for _ in range(E))


def _case_id(case):
    shape, dtype, plan = case
    if plan is None:
        return f"{shape[0]}-f32"
    return f"{shape[0]}-bf16-tm{plan.tile_rows}-c{plan.cluster}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_kernel_matches_plain(cuda, case):
    (name, E, R, I, hidden, O), dtype, plan = case
    towers = _towers(E, I, hidden, O, seed=len(name)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(R, I)).astype(np.float32) * 0.5).to(cuda, dtype)
    flat = fused_enn.flatten_weights(
        fused_enn.stacked_layers(list(towers)), dtype, cuda)
    got = fused_enn.fused_enn_cuda(flat, x, plan)
    ref = fused_enn.fused_stacked_mlp_reference(flat, x)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (E, R, O)
    err = (got.float() - ref.float()).abs().max().item()
    print(f"{_case_id(case)}: max|d| {err:.3g}", flush=True)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [96000, 169000])
def test_zero_rows_give_selu_of_the_biases(cuda, rows, dtype):
    """The EMN's memories start at zero: its first pass feeds the kernel
    all-zero rows."""
    towers = _towers(1, 100, [250] * 4, 100, seed=9).to(cuda)
    x = torch.zeros(rows, 100, device=cuda, dtype=dtype)
    flat = fused_enn.flatten_weights(
        fused_enn.stacked_layers(list(towers)), dtype, cuda)
    got = fused_enn.fused_enn_cuda(flat, x)
    ref = fused_enn.fused_stacked_mlp_reference(flat, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # every row is the same function of the biases alone
    assert torch.equal(got[0], got[0, :1].expand(rows, -1))


@pytest.mark.gpu
@pytest.mark.parametrize("model,packed,launches", [
    ("MNN", True, 0), ("S2V", True, 0), ("AttS2V", True, 0),
    ("AttGGNN", True, 6), ("EMN", True, 9), ("EMN", False, 8)])
def test_model_forward_launches_and_matches_the_plain_path(cuda, model,
                                                           packed, launches):
    from graphinvent_tpu_torch.config import preset
    from graphinvent_tpu_torch.models import build_model
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    cfg = preset(model, device="cuda", emn_packed=packed)
    net = build_model(cfg, torch.Generator().manual_seed(0)).to(cuda)
    nodes, edges = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                    for a in synthetic_graphs(cfg, 200, seed=2))
    fused_enn.reset_launch_counts()
    with torch.inference_mode():
        fused = net(nodes, edges).float()
        assert sum(fused_enn.LAUNCHES.values()) == launches
        net.cfg = cfg.replace(fused_inference_enn=False)
        plain = net(nodes, edges).float()
    assert sum(fused_enn.LAUNCHES.values()) == launches
    assert bool(torch.isfinite(fused).all())
    assert (fused - plain).abs().max().item() <= 0.15
    net.cfg = cfg
    net(nodes, edges, train=True).float().sum().backward()
    assert sum(fused_enn.LAUNCHES.values()) == launches
    assert all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())


@pytest.mark.gpu
def test_dispatch_counts_launches_and_takes_any_lead_dims(cuda):
    towers = _towers(1, 60, [120] * 2, 30, seed=3).to(cuda)
    fused_enn.reset_launch_counts()
    with torch.inference_mode():
        for shape in ((7, 13, 60), (91, 60)):
            x = torch.randn(*shape, device=cuda)
            got = fused_enn.fused_mlp(towers[0], x)
            flat = fused_enn.flatten_weights(
                fused_enn.stacked_layers([towers[0]]), x.dtype, cuda)
            ref = fused_enn.fused_stacked_mlp_reference(
                flat, x.reshape(-1, 60)).reshape(*shape[:-1], 30)
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    assert fused_enn.LAUNCHES["fused_mlp"] == 2
    assert fused_enn.LAUNCHES_BY_LAYOUT == {(1, 60, 120, 120, 30): 2}


@pytest.mark.gpu
def test_launch_refuses_bad_inputs(cuda):
    towers = _towers(2, 16, [32], 8, seed=1).to(cuda)
    flat = fused_enn.flatten_weights(
        fused_enn.stacked_layers(list(towers)), torch.float32, cuda)
    with pytest.raises(ValueError):
        fused_enn.fused_enn_cuda(flat, torch.randn(4, 17, device=cuda))
    with pytest.raises(TypeError):
        fused_enn.fused_enn_cuda(
            flat, torch.randn(4, 16, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        fused_enn.fused_enn_cuda(flat, torch.randn(4, 16))
    bf16 = fused_enn.flatten_weights(
        fused_enn.stacked_layers(list(towers)), torch.bfloat16, cuda)
    x = torch.randn(4, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):           # 128-row tiles take no cluster
        fused_enn.fused_enn_cuda(bf16, x, fused_enn.LaunchPlan(128, 8))


# --------------------------------------------------------------------------
# the training path on the card
# --------------------------------------------------------------------------

def _train_setup(cuda, compute_dtype):
    from graphinvent_tpu_torch.config import preset
    from graphinvent_tpu_torch.models import build_model
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    cfg = preset("GGNN", device="cuda", compute_dtype=compute_dtype)
    model = build_model(cfg, torch.Generator().manual_seed(0)).to(cuda)
    nodes, edges = synthetic_graphs(cfg, 96, seed=1)
    rng = np.random.default_rng(1)
    apds = np.zeros((96, cfg.dim_apd), np.int8)
    apds[np.arange(96), rng.integers(0, cfg.dim_apd, 96)] = 1
    apds[::5, 3] += 2
    valid = np.ones(96, np.float32)
    valid[-7:] = 0
    return cfg, model, {"nodes": nodes.astype(np.int8),
                        "edges": edges.astype(np.int8), "apds": apds,
                        "valid": valid}


@pytest.mark.gpu
def test_wire_formats_decode_to_the_same_tensors_on_the_card(cuda):
    """Pinned, non-blocking uploads on the copy stream, then the bit
    unpacking and the scatter-add on the device: byte-equal to numpy."""
    from graphinvent_tpu_torch.data.loader import pack_rows, sparse_apds
    from graphinvent_tpu_torch.train import step
    cfg, _, rows = _train_setup(cuda, "float32")
    idx, val = sparse_apds(rows["apds"], 32)
    sparse = {"nodes_p": pack_rows(rows["nodes"]),
              "edges_p": pack_rows(rows["edges"]), "apds_i": idx,
              "apds_v": val, "valid": rows["valid"]}
    place = step.BatchUploader(cuda)
    for _ in range(3):                  # the pinned buffers are reused
        got = step.batch_arrays(cfg, place(sparse), torch.float32)
        want = step.batch_arrays(cfg, place(rows), torch.float32)
        for g, w, name in zip(got, want, ("nodes", "edges", "apds")):
            assert g.device.type == "cuda" and torch.equal(g, w)
            np.testing.assert_array_equal(
                g.cpu().numpy(), rows[name].astype(np.float32))
    packed = torch.from_numpy(sparse["edges_p"]).to(cuda)
    np.testing.assert_array_equal(
        step.unpackbits(packed, 507).cpu().numpy(),
        np.unpackbits(sparse["edges_p"], axis=1, count=507))


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_step_launches_no_kernel_and_eval_steps_ten(cuda,
                                                          compute_dtype):
    from graphinvent_tpu_torch.train import step
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    cfg, model, rows = _train_setup(cuda, compute_dtype)
    batch = step.BatchUploader(cuda)(rows)
    adam = Adam(model)
    train = step.make_train_step(cfg, onecycle_for_config(cfg, 10), model,
                                 adam)
    fused_enn.reset_launch_counts()
    first = train(batch).item()
    for _ in range(5):
        last = train(batch).item()
    assert sum(fused_enn.LAUNCHES.values()) == 0
    assert np.isfinite([first, last]).all() and last < first
    loss = step.make_eval_step(cfg, model)(batch)
    assert sum(fused_enn.LAUNCHES.values()) == 10
    nll = step.make_likelihood_step(cfg, model)(batch)
    assert sum(fused_enn.LAUNCHES.values()) == 20
    # the kernel path scores the weights the six updates left: it agrees
    # with the plain path on them (f32 1e-4; bf16 0.05 on a loss of ~6)
    plain_cfg = cfg.replace(fused_inference_enn=False)
    model.cfg = plain_cfg
    plain = step.make_eval_step(plain_cfg, model)(batch)
    assert sum(fused_enn.LAUNCHES.values()) == 20
    tol = 1e-4 if compute_dtype == "float32" else 0.05
    assert abs(loss.item() - plain.item()) <= tol
    assert nll.shape == (96,) and bool(torch.isfinite(nll).all())


# --------------------------------------------------------------------------
# the sampler's round as a captured CUDA graph (sampling/round_graphs.py)
# against the eager loop: the same bytes, generator state and launches
# --------------------------------------------------------------------------

SAMPLED_MODELS = ("MNN", "S2V", "AttS2V", "GGNN", "AttGGNN", "EMN")


def _sampled_model(cuda, name, compute_dtype="bfloat16"):
    """``preset(name)`` at B=1000, N=13 with seeded weights and the APD
    head's "add to node 0" and "terminate" logits raised by 4 and 2, so
    that rollouts build graphs for several rounds."""
    from graphinvent_tpu_torch.config import preset
    from graphinvent_tpu_torch.models import build_model
    cfg = preset(name, device="cuda", compute_dtype=compute_dtype)
    model = build_model(cfg, torch.Generator().manual_seed(0)).to(cuda).eval()
    head = model.APDReadout
    with torch.no_grad():
        head.fAddNet2.linears[-1].bias[:cfg.len_f_add_per_node] += 4.0
        head.fTermNet2.linears[-1].bias[:] += 2.0
    return cfg, model


def _sample_both(cfg, model, cuda, batches=(0, 1), **kw):
    """Each batch on the graphed and on the eager sampler: (packed bytes,
    the generator's state after, launch counts) per batch and way."""
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    out = {}
    for eager in (False, True):
        sampler = GraphSampler(cfg, cfg.batch_size, device=cuda,
                               _eager=eager)
        rows = []
        for k in batches:
            gen = batch_generator(3, k, cuda)
            fused_enn.reset_launch_counts()
            packed = sampler.sample_packed(model, gen, **kw)
            rows.append((packed, gen.get_state(), fused_enn.launch_counts()))
        out[eager] = rows
        if not eager:
            out["captures"] = sampler._graphs.captures
    return out


def _assert_same(out):
    for (pg, sg, lg), (pe, se, le) in zip(out[False], out[True]):
        assert pg.tobytes() == pe.tobytes()
        assert torch.equal(sg, se)
        assert lg == le


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", SAMPLED_MODELS)
def test_graphed_sampler_matches_the_eager_loop(cuda, name, compute_dtype):
    from graphinvent_tpu_torch.sampling.generator import _packed_rounds
    cfg, model = _sampled_model(cuda, name, compute_dtype)
    out = _sample_both(cfg, model, cuda)
    _assert_same(out)
    assert out["captures"] == 1            # the second batch replays
    rounds = [_packed_rounds(cfg, p) for p, _, _ in out[False]]
    assert min(rounds) >= 3
    if name == "GGNN":
        assert sum(out[False][0][2][0].values()) == 10 * rounds[0]


@pytest.mark.gpu
def test_graphed_sampler_two_phase_hooks(cuda):
    from graphinvent_tpu_torch.sampling.generator import _row_layout
    from graphinvent_tpu_torch.sampling.two_phase import _device_unpack_state
    cfg, model = _sampled_model(cuda, "GGNN")
    first = _sample_both(cfg, model, cuda, batches=(0,), stop_round=2)
    _assert_same(first)
    packed = first[False][0][0]
    d0 = _row_layout(cfg)["done"][0]
    assert (packed[:, d0] == 0).any()      # rows still live after round 2
    init = _device_unpack_state(cfg, torch.from_numpy(packed).to(cuda))
    _assert_same(_sample_both(cfg, model, cuda, batches=(5,),
                              init_state=init))


@pytest.mark.gpu
def test_graphed_sampler_recaptures_on_new_weights_and_path(cuda):
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    cfg, model = _sampled_model(cuda, "GGNN")
    graphed = GraphSampler(cfg, cfg.batch_size, device=cuda)
    eager = GraphSampler(cfg, cfg.batch_size, device=cuda, _eager=True)

    def both(k):
        return (graphed.sample_packed(model, batch_generator(4, k, cuda)),
                eager.sample_packed(model, batch_generator(4, k, cuda)))

    before = both(0)
    assert before[0].tobytes() == before[1].tobytes()
    # in place, as Adam updates: a plain-path site's bias, then the
    # kernel's message MLPs; the graphs stay and read the new weights
    with torch.no_grad():
        model.APDReadout.fTermNet2.linears[-1].bias.sub_(3.0)
    g, e = both(0)
    assert g.tobytes() == e.tobytes() != before[0].tobytes()
    with torch.no_grad():
        for p in model.msg_nns.parameters():
            p.mul_(1.25)
    moved = both(0)
    assert moved[0].tobytes() == moved[1].tobytes() != g.tobytes()
    assert (graphed._graphs.captures, graphed._graphs.refreshes) == (1, 2)
    model.cfg = cfg.replace(fused_inference_enn=False)
    fused_enn.reset_launch_counts()
    g, e = both(1)
    assert g.tobytes() == e.tobytes()
    assert sum(fused_enn.LAUNCHES.values()) == 0
    assert graphed._graphs.captures == 2


@pytest.mark.gpu
def test_graphed_sampler_calls_forward_hooks_as_the_eager_loop(cuda):
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    cfg, model = _sampled_model(cuda, "GGNN")
    seen = {}
    for eager in (False, True):
        calls = seen[eager] = []
        sampler = GraphSampler(cfg, cfg.batch_size, device=cuda,
                               _eager=eager)
        sampler.sample_packed(model, batch_generator(5, 1, cuda))

        def keep(module, args, output):
            calls.append((args[0].clone(), args[1].clone(), output.clone()))

        def shift(module, args, output):
            return output + 0.5 * (output > 0)

        handles = [model.register_forward_hook(keep),
                   model.register_forward_hook(shift)]
        packed = sampler.sample_packed(model, batch_generator(5, 0, cuda))
        for h in handles:
            h.remove()
        calls.append(packed)
        if not eager:
            graphed_captures = sampler._graphs.captures
    assert len(seen[False]) == len(seen[True]) >= 4
    assert graphed_captures == 1         # hooks need no capture of their own
    for got, want in zip(seen[False][:-1], seen[True][:-1]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert seen[False][-1].tobytes() == seen[True][-1].tobytes()

    # a forward pre-hook keeps the eager loop: nothing is captured
    sampler = GraphSampler(cfg, cfg.batch_size, device=cuda)
    handle = model.register_forward_pre_hook(lambda module, args: None)
    sampler.sample_packed(model, batch_generator(5, 0, cuda))
    handle.remove()
    assert sampler._graphs.captures == 0


# --------------------------------------------------------------------------
# the resident train epoch's steps as replays of a captured CUDA graph
# (train/step_graphs.py) against the eager loop: byte-equal losses,
# weights, moments, Adam's step and the dropout generator's state
# --------------------------------------------------------------------------

def _train_data(cuda, name, rows=200, batch=64):
    """``preset(name)`` (bf16, N=13) with every dropout at 0.1, so that
    the graph draws masks, and ``rows`` seeded rows resident on the card
    (the last batch padded)."""
    from dataclasses import fields
    from types import SimpleNamespace
    from graphinvent_tpu_torch.config import preset
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    cfg = preset(name, device="cuda", compute_dtype="bfloat16",
                 batch_size=batch)
    cfg = cfg.replace(**{f.name: 0.1 for f in fields(cfg)
                         if f.name.endswith("_dropout_p")})
    nodes, edges = synthetic_graphs(cfg, rows, seed=2)
    rng = np.random.default_rng(2)
    apds = np.zeros((rows, cfg.dim_apd), np.int8)
    apds[np.arange(rows), rng.integers(0, cfg.dim_apd, rows)] = 1
    apds[::4, 5] += 1

    def put(a):
        return torch.from_numpy(a.astype(np.int8)).to(cuda)
    return cfg, SimpleNamespace(nodes=put(nodes), edges=put(edges),
                                apds=put(apds), device=cuda, n_rows=rows)


def _trainer(cfg, data, eager, adam_cls=None):
    """(model, adam, epoch fn): seeded weights, OneCycle over 3 epochs."""
    import math
    from graphinvent_tpu_torch.models import build_model
    from graphinvent_tpu_torch.train.device_data import make_epoch_train_fn
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    model = build_model(cfg, torch.Generator().manual_seed(0)).to(
        data.device)
    adam = (adam_cls or Adam)(model)
    schedule = onecycle_for_config(cfg.replace(epochs=3), math.ceil(
        data.n_rows / cfg.batch_size))
    return model, adam, make_epoch_train_fn(cfg, schedule, data, model, adam,
                                            _eager=eager)


def _epoch(fn, cfg, data, e, step_losses=None):
    """Epoch ``e`` (its own permutation and dropout generator): (mean
    loss, per-step losses, the generator's state after)."""
    from graphinvent_tpu_torch.sampling.generator import (
        STREAM_DROPOUT, seeded_generator,
    )
    from graphinvent_tpu_torch.train.device_data import epoch_permutation
    perm = epoch_permutation(data.n_rows, cfg.batch_size,
                             np.random.default_rng(e))
    gen = seeded_generator([5, e], data.device, STREAM_DROPOUT)
    losses = [] if step_losses is None else step_losses
    mean = fn(perm, gen, losses)
    return mean, torch.stack(losses).cpu(), gen.get_state()


def _assert_same_training(a, b):
    """Two (model, adam, epochs) runs, byte for byte."""
    (ma, aa, ea), (mb, ab, eb) = a, b
    assert aa.step == ab.step
    for x, y in zip(ea, eb):
        assert x[0] == y[0]
        assert torch.equal(x[1], y[1]) and torch.equal(x[2], y[2])
    for ta, tb in zip(list(ma.parameters()) + aa.mu + aa.nu,
                      list(mb.parameters()) + ab.mu + ab.nu):
        assert torch.equal(ta, tb)


@pytest.mark.gpu
def test_adam_stage_does_not_wait_for_queued_work(cuda):
    """The eager step's staged scalars are a copy queued on the stream:
    with a long kernel queued before it, the stream is still busy when
    ``stage`` returns, and each copy lands its own values (a pinned buffer
    is not handed out again while a copy may still read it)."""
    from graphinvent_tpu_torch.train.optim import Adam, adam_scalars
    adam = Adam(torch.nn.Linear(4, 3).to(cuda))
    stream = torch.cuda.current_stream(cuda)
    staged = []
    for lr in (1e-3, 2e-3, 3e-3):
        torch.cuda._sleep(1 << 28)        # about 0.1 s of spinning
        staged.append(adam.stage(lr, 0.9))
        assert not stream.query()
    torch.cuda.synchronize(cuda)
    for t, (lr, got) in enumerate(zip((1e-3, 2e-3, 3e-3), staged), 1):
        np.testing.assert_array_equal(
            got.cpu().numpy(), adam_scalars(t, lr, 0.9, adam.beta2))


@pytest.mark.gpu
@pytest.mark.parametrize("name", SAMPLED_MODELS)
def test_graphed_epochs_match_the_eager_loop(cuda, name):
    """Two epochs each way: the first captures after its first step, the
    second only replays; 0 kernel launches in the train steps.  Then the
    validation loss on the kernel path reads the new weights on both
    (the version counters moved after the replays), byte-equal."""
    from graphinvent_tpu_torch.train.device_data import (
        epoch_permutation, make_epoch_eval_fn,
    )
    cfg, data = _train_data(cuda, name)
    vperm = epoch_permutation(data.n_rows, cfg.batch_size,
                              np.random.default_rng(9))
    runs, valid = {}, {}
    for eager in (False, True):
        model, adam, fn = _trainer(cfg, data, eager)
        evaluate = make_epoch_eval_fn(cfg, data, model)
        before = evaluate(vperm)           # fills the wrappers' caches
        fused_enn.reset_launch_counts()
        epochs = [_epoch(fn, cfg, data, e) for e in range(2)]
        assert sum(fused_enn.LAUNCHES.values()) == 0
        valid[eager] = (before, evaluate(vperm),
                        sum(fused_enn.LAUNCHES.values()))
        runs[eager] = (model, adam, epochs)
        if eager:
            assert fn.graphs is None
        else:
            assert (fn.graphs.captures, fn.graphs.replays) == (1, 7)
            assert all(p.grad is None for p in adam.params)
    _assert_same_training(runs[False], runs[True])
    assert valid[False] == valid[True]
    assert valid[False][1] != valid[False][0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", SAMPLED_MODELS)
def test_graphed_epoch_runs_a_hooked_step_eagerly_between_replays(cuda,
                                                                   name):
    """In the second epoch a one-shot forward hook is armed after step 0:
    step 1 runs eagerly (the hook sees its logits, an Adam subclass's
    ``update`` runs), steps 0, 2 and 3 replay; byte-equal to the eager
    loop."""
    from graphinvent_tpu_torch.train.optim import Adam

    class CountingAdam(Adam):
        calls = 0

        def update(self, lr, beta1=0.9):
            self.calls += 1
            super().update(lr, beta1)

    cfg, data = _train_data(cuda, name)
    runs, seen = {}, {}
    for eager in (False, True):
        model, adam, fn = _trainer(cfg, data, eager, CountingAdam)
        logits = seen[eager] = []

        class Arming(list):
            def append(self, loss):
                super().append(loss)
                if len(self) == 1:
                    box = {}

                    def hook(module, args, output):
                        logits.append(output.detach().float().cpu())
                        box["handle"].remove()
                    box["handle"] = model.register_forward_hook(hook)

        epochs = [_epoch(fn, cfg, data, 0), _epoch(fn, cfg, data, 1,
                                                   Arming())]
        runs[eager] = (model, adam, epochs)
        if not eager:
            assert (fn.graphs.captures, fn.graphs.replays) == (1, 6)
    _assert_same_training(runs[False], runs[True])
    # the warm-up step before the capture and the hooked step: eager
    assert runs[False][1].calls == 2 and runs[True][1].calls == 8
    assert len(seen[False]) == len(seen[True]) == 1
    assert torch.equal(seen[False][0], seen[True][0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", SAMPLED_MODELS)
def test_graphed_epochs_restart_from_a_checkpoint(cuda, name):
    """A checkpoint after epoch 1: a new model and Adam loaded from it,
    and the first ones loaded back in place (which keeps their graph),
    run epoch 2 to the same per-step losses and weights as the
    uninterrupted run."""
    import copy
    cfg, data = _train_data(cuda, name)
    model, adam, fn = _trainer(cfg, data, False)
    _epoch(fn, cfg, data, 0)
    saved = (copy.deepcopy(model.state_dict()), adam.state_dict())
    want = _epoch(fn, cfg, data, 1)
    after = [t.clone() for t in model.parameters()]

    model2, adam2, fn2 = _trainer(cfg, data, False)
    model2.load_state_dict(saved[0])
    adam2.load_state_dict(saved[1])
    got = _epoch(fn2, cfg, data, 1)
    model.load_state_dict(saved[0])
    adam.load_state_dict(saved[1])
    again = _epoch(fn, cfg, data, 1)
    assert fn.graphs.captures == 1 and fn2.graphs.captures == 1
    for run, m, a in ((got, model2, adam2), (again, model, adam)):
        assert run[0] == want[0] and torch.equal(run[1], want[1])
        assert torch.equal(run[2], want[2]) and a.step == 8
        assert all(torch.equal(x, y) for x, y in zip(m.parameters(), after))


@pytest.mark.gpu
def test_graphed_epoch_recaptures_on_a_replaced_tensor_or_cfg(cuda):
    cfg, data = _train_data(cuda, "GGNN")
    model, adam, fn = _trainer(cfg, data, False)
    _epoch(fn, cfg, data, 0)
    lin = model.APDReadout.fTermNet2.linears[-1]
    i = next(k for k, p in enumerate(adam.params) if p is lin.bias)
    lin.bias = adam.params[i] = torch.nn.Parameter(lin.bias.detach().clone())
    _epoch(fn, cfg, data, 1)
    assert fn.graphs.captures == 2
    model.cfg = cfg.replace(message_passes=cfg.message_passes)  # equal cfg
    _epoch(fn, cfg, data, 2)
    assert fn.graphs.captures == 2
    model.cfg = cfg.replace(fused_inference_enn=False)
    _epoch(fn, cfg, data, 2)
    assert fn.graphs.captures == 3


@pytest.mark.gpu
def test_a_train_capture_makes_an_earlier_sampler_graph_recapture(cuda):
    """A train capture drops the library's workspaces, which a round
    captured before it reads: the sampler captures again, and its batches
    stay byte-equal to the eager loop's on the weights the epoch left."""
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    cfg, data = _train_data(cuda, "GGNN")
    model, _, fn = _trainer(cfg, data, False)
    sample_cfg = cfg.replace(batch_size=256)
    graphed = GraphSampler(sample_cfg, 256, device=cuda)
    eager = GraphSampler(sample_cfg, 256, device=cuda, _eager=True)

    def both(k):
        return (graphed.sample_packed(model, batch_generator(6, k, cuda)),
                eager.sample_packed(model, batch_generator(6, k, cuda)))

    g, e = both(0)
    assert g.tobytes() == e.tobytes()
    _epoch(fn, cfg, data, 0)
    g2, e2 = both(0)
    assert g2.tobytes() == e2.tobytes() != g.tobytes()
    assert graphed._graphs.captures == 2 and fn.graphs.captures == 1
