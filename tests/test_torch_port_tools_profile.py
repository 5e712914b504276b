"""The port's measuring tools (graphinvent_tpu_torch/tools/) on the CPU at
tiny widths: the roofline's FLOP count of a GGNN train step against the
analytic count of its products, and the profilers, the two-phase A/B and
the occupancy study each run once and print their JSON line.  Without a
card every tool raises unless ``--device cpu`` is given."""

import json
import os

import numpy as np
import pytest
import torch

import _torch_port_util  # noqa: F401  (caps torch's threads)
from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.models import build_model
from graphinvent_tpu_torch.tools import (
    ab_two_phase, common, moses_metrics, occupancy, profile_rl,
    profile_sampler, profile_step, roofline, train_qsar,
)
from graphinvent_tpu_torch.utils.weights import save_checkpoint


def tiny(model="GGNN", **kw):
    """The tools' ``preset`` at the tests' tiny widths."""
    return port_tiny(model, **kw)


def ggnn_step_matmul_flops(cfg, B):
    """Analytic FLOPs of the products of one GGNN train step: every
    forward product 2*M*K*N, and in the backward one product of that size
    for the weight's gradient and one for the input's where the input
    needs a gradient (the first pass's hidden state and the edge tensor
    come from the data and need none)."""
    N, Fn = cfg.dim_nodes
    H, M, E = cfg.hidden_node_features, cfg.message_size, cfg.n_edge_features
    G, R = cfg.gather_width, B * N

    def mlp(rows, dims, input_grad=True, towers=1):
        total = 0
        for l, (k, o) in enumerate(zip(dims[:-1], dims[1:])):
            f = 2 * rows * k * o * towers
            total += f + f + (f if (l > 0 or input_grad) else 0)
        return total

    enn = [H] + [cfg.enn_hidden_dim] * cfg.enn_depth + [M]
    total = 0
    for p in range(cfg.message_passes):
        total += mlp(R, enn, input_grad=p > 0, towers=E)
        contraction = 2 * B * N * (N * E) * M
        total += 2 * contraction                  # forward + d(messages)
        gi = 2 * R * M * 3 * H
        gh = 2 * R * H * 3 * H
        total += 3 * gi + 2 * gh + (gh if p > 0 else 0)
    att = [H + Fn] + [cfg.gather_att_hidden_dim] * cfg.gather_att_depth + [G]
    emb = [H] + [cfg.gather_emb_hidden_dim] * cfg.gather_emb_depth + [G]
    total += mlp(R, att) + mlp(R, emb)
    h1 = [cfg.mlp1_hidden_dim] * cfg.mlp1_depth
    h2 = [cfg.mlp2_hidden_dim] * cfg.mlp2_depth
    fa, fc = cfg.len_f_add_per_node, cfg.len_f_conn_per_node
    total += mlp(R, [H] + h1 + [fa]) + mlp(R, [H] + h1 + [fc])
    total += mlp(B, [N * fa + G] + h2 + [N * fa])
    total += mlp(B, [N * fc + G] + h2 + [N * fc])
    total += mlp(B, [G] + h2 + [1])
    return total


@pytest.mark.parametrize("B", [3, 8])
def test_roofline_flops_of_a_ggnn_step_are_the_analytic_count(B):
    cfg = tiny(batch_size=B, device="cpu")
    model = build_model(cfg, torch.Generator().manual_seed(0))
    batch = common.to_device(common.synthetic_rows(cfg, B), "cpu")
    got = roofline.step_flops(cfg, model, batch)
    assert got == ggnn_step_matmul_flops(cfg, B)


def test_roofline_rows_on_the_cpu_have_no_device_shares(monkeypatch, capsys):
    monkeypatch.setattr(roofline, "preset", tiny)
    out = roofline.main(["--batch", "4", "--nodes", "13", "--steps", "1",
                         "--repeats", "1", "--device", "cpu"])
    out_s = roofline.main(["--batch", "4", "--nodes", "13", "--repeats", "1",
                           "--sampler", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out_s
    for row in out["rows"] + out_s["rows"]:
        assert row["device"] == "cpu" and row["card"] is None
        assert row["mfu"] is None and row["sol_fraction"] is None
        assert row["n"] == 13 and row["batch"] == 4
    step, rnd = out["rows"][0], out_s["rows"][0]
    assert step["flops"] > 0 and step["step_time_s"] > 0
    assert step["hbm_min_bytes"] == 28 * step["n_params"] + step["batch_bytes"]
    assert rnd["flops_per_round"] > 0 and rnd["round_time_s"] > 0


def test_roofline_takes_its_batch_from_a_dataset(tmp_path):
    from graphinvent_tpu_torch.data import store
    cfg = tiny(batch_size=4, device="cpu")
    rows = common.synthetic_rows(cfg, 6, seed=3)
    store.write_arrays(str(tmp_path / "train.npd"),
                       {"nodes": rows["nodes"], "edges": rows["edges"],
                        "APDs": rows["apds"]})
    got = common.dataset_rows(cfg, str(tmp_path), 4)
    for k in ("nodes", "edges", "apds"):
        assert np.array_equal(got[k], rows[k][:4])
    with pytest.raises(ValueError, match="fewer than"):
        common.dataset_rows(cfg, str(tmp_path), 7)


def tiny_checkpoint(tmp_path, **kw):
    cfg = tiny(device="cpu", **kw)
    save_checkpoint(build_model(cfg, torch.Generator().manual_seed(1)),
                    str(tmp_path), 1)
    return os.path.join(str(tmp_path), "model_restart_1.pth")


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_ab_two_phase_runs_and_prints_its_line(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setattr(ab_two_phase, "preset", tiny)
    ckpt = tiny_checkpoint(tmp_path)
    out = ab_two_phase.main([ckpt, "4", "float32", "13", "false", "2", "2",
                             "--device", "cpu"])
    assert last_json(capsys) == out
    assert out["molecules"] == 8 and out["R"] == 2
    assert out["single_molecules_per_s"] > 0
    assert out["two_phase_molecules_per_s"] > 0
    assert out["actions"]["max"] >= out["actions"]["p50"] >= 1


def test_occupancy_runs_and_prints_its_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ab_two_phase, "preset", tiny)
    ckpt = tiny_checkpoint(tmp_path)
    out = occupancy.main([ckpt, "4", "float32", "13", "false", "2",
                          "--device", "cpu"])
    assert last_json(capsys) == out
    assert len(out["live"]) == out["rounds"] and out["live"][0] == 1.0
    assert len(out["caps"]) == 5


def test_occupancy_curve_and_caps():
    t = np.array([1, 2, 2, 4])
    live = occupancy.occupancy_curve(t, 4)
    assert np.allclose(live, [1.0, 0.75, 0.25, 0.25])
    assert occupancy.caps(live, 4)[0] == {"R": 2, "done": 0.75,
                                          "rounds": 2.5, "speedup": 1.6}


def test_profile_sampler_runs_and_prints_its_line(monkeypatch, capsys):
    monkeypatch.setattr(profile_sampler, "preset", tiny)
    out = profile_sampler.main(["4", "float32", "--device", "cpu"])
    assert last_json(capsys) == out
    assert out["stub_rounds"] == out["forced_rounds"] >= 2
    for key in ("forward_s", "device_loop_s", "pack_s", "device_to_host_s",
                "host_decode_s", "sample_s"):
        assert out[key] > 0, key
    assert out["busy_share"] is None


def test_profile_step_runs_and_prints_its_line(monkeypatch, capsys):
    monkeypatch.setattr(profile_step, "preset", tiny)
    out = profile_step.main(["4", "float32", "--iters", "1", "--device",
                             "cpu"])
    assert last_json(capsys) == out
    assert len(out["sections_s"]) == 7
    assert list(out["step_split_s"]) == ["forward", "backward", "optimizer"]
    only = profile_step.main(["4", "float32", "gather", "--iters", "1",
                              "--device", "cpu"])
    assert list(only["sections_s"]) == ["graph gather"]


def test_profile_rl_runs_and_prints_its_line(monkeypatch, capsys):
    monkeypatch.setattr(profile_rl, "preset", tiny)
    out = profile_rl.main(["4", "1", "--dtype", "float32", "--device",
                           "cpu"])
    assert last_json(capsys) == out
    assert out["steps"] == 1
    assert set(out["pieces_s"]) == {
        "agent_rollout", "prior_replay", "basf_rollout_and_replay",
        "scoring", "grad_forward", "grad_backward", "adam"}


def _default_device_runs(tmp_path):
    ckpt = str(tmp_path / "none.pth")
    smi = str(tmp_path / "a.smi")
    with open(smi, "w") as fh:
        fh.write("SMILES\nCCO\nC1CC1\n")
    return {
        "roofline": lambda: roofline.main(["--batch", "2"]),
        "profile_step": lambda: profile_step.main(["2"]),
        "profile_sampler": lambda: profile_sampler.main(["2"]),
        "profile_rl": lambda: profile_rl.main(["2", "1"]),
        "ab_two_phase": lambda: ab_two_phase.main([ckpt]),
        "occupancy": lambda: occupancy.main([ckpt]),
        "train_qsar": lambda: train_qsar.main([smi, smi, ckpt]),
        "moses_metrics": lambda: moses_metrics.main([smi, "--train", smi]),
    }


@pytest.mark.parametrize("tool", ["roofline", "profile_step",
                                  "profile_sampler", "profile_rl",
                                  "ab_two_phase", "occupancy", "train_qsar",
                                  "moses_metrics"])
def test_a_tool_without_a_card_raises_unless_asked_for_the_cpu(tool,
                                                               tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    run = _default_device_runs(tmp_path)[tool]
    with pytest.raises((RuntimeError, ValueError),
                       match="cuda|CUDA"):
        run()
