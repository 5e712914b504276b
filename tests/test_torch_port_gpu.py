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
