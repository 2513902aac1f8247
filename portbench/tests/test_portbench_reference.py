"""The plain reference against the port at a tiny size on the CPU: a serve
round through prefill and decode on both families and both paths, and the
controls in the lower precision, which the comparison has to fail."""
import time

import pytest
import torch

import tiny
from portbench.harness import serve


def _round(cfg, traffic, seed=20241018, control=None, rounds=1):
    return serve.run({"rounds_per_s": float(rounds)}, cfg, traffic, seed,
                     1.0, False, torch.device("cpu"), time.perf_counter(),
                     calibrate={"control": control})


def _cfg(family):
    return tiny.dropless_moe() if family == "dropless" else tiny.get(family)


@pytest.mark.parametrize("family,path,check", [
    ("dense", "float", "sequences"), ("dense", "cim", "replay"),
    ("moe", "float", "replay"), ("dropless", "float", "sequences")])
def test_reference_follows_the_port(family, path, check):
    rec = _round(_cfg(family), tiny.get(path))
    assert rec["check"] == check
    assert rec["completed"] == rec["attempted"] == len(
        tiny.get(path)["round_gens"])
    assert rec["check_tokens"] == rec["output_tokens"] == sum(
        tiny.get(path)["round_gens"])
    # bf16 activations against a float32 reference: argmax ties apart; with
    # experts, a near tie in the routing can move one token's logits, so
    # the MoE family is held by its mean gap, as its cell is
    if family in ("moe", "dropless"):
        assert rec["mean_gap"] < 0.05
    else:
        assert rec["widest_gap"] < 0.05
    if path == "cim":
        assert rec["step_access_gap"] == 0 and rec["step_dispatch_gap"] == 0


def test_cim_control_fails():
    rec = _round(tiny.get("dense"), tiny.get("cim"), control="cim4")
    assert rec["widest_gap"] < 0.05 < rec["control_widest_gap"]


def test_fp8_control_fails():
    cfg = tiny.get("dense")
    cfg.update(hidden_size=256, intermediate_size=512, vocab_size=1000)
    cfg["port"].update(d_model=256, d_ff=512, vocab_size=1000, head_dim=64)
    traffic = tiny.get("float")
    traffic["round_gens"] = [8, 12, 10]
    rec = _round(cfg, traffic, control="fp8")
    assert rec["widest_gap"] < 0.05 < rec["control_widest_gap"]


def test_moe_capacity_drops_in_decode():
    """The tiny MoE's decode steps drop choices (3 slots x top 3 over 8
    experts, one place each): the reference follows only because it
    replays the same batches."""
    cfg = tiny.get("moe")
    k, e, n = cfg["num_experts_per_tok"], cfg["n_routed_experts"], 3
    assert max(int(cfg["capacity_factor"] * k * n / e), 1) == 1
    rec = _round(cfg, tiny.get("float"))
    assert rec["mean_gap"] < 0.05


@pytest.mark.parametrize("family", ["dense", "dropless"])
def test_sequences_read_what_the_replay_reads(monkeypatch, family):
    """Where no row is coupled, reading each judged request as one sequence
    gives the gaps that replaying the whole run gives."""
    from portbench.harness import check

    seq = _round(_cfg(family), tiny.get("float"), seed=11, rounds=2)
    monkeypatch.setattr(check, "rows_coupled", lambda cfg, traffic: True)
    rep = _round(_cfg(family), tiny.get("float"), seed=11, rounds=2)
    assert (seq["check"], rep["check"]) == ("sequences", "replay")
    assert seq["check_tokens"] == rep["check_tokens"] > 0
    assert seq["mean_gap"] == pytest.approx(rep["mean_gap"], abs=1e-3)
    assert seq["widest_gap"] == pytest.approx(rep["widest_gap"], abs=1e-3)


def test_rows_coupled_by_the_configuration():
    from portbench.harness import check, common

    moe = tiny.dropless_moe()
    granite = common.load_json("configs", "granite-3-8b-stage")
    float_mix = common.load_json("traffic", "float-decode")
    cim_mix = common.load_json("traffic", "cim-decode")
    # 3 x top 3 >= 8 experts: no call of N tokens drops a choice
    assert not check.rows_coupled(moe, float_mix)
    assert all(int(moe["capacity_factor"] * 3 * n / 8) >= n
               for n in range(1, 70000))
    assert not check.rows_coupled(granite, float_mix)
    assert check.rows_coupled(granite, cim_mix)
    assert check.rows_coupled(tiny.get("moe"), tiny.get("float"))


@pytest.mark.parametrize("seed", [5, 6])
def test_several_rounds_in_one_run(seed):
    """Rounds follow each other in one engine run; the judged round is
    drawn from the seed and replayed from the run's start."""
    traffic = tiny.get("float")
    rec = _round(tiny.get("moe"), traffic, seed=seed, rounds=3)
    assert rec["rounds"] == 3 and rec["attempted"] == 12 == rec["completed"]
    assert rec["output_tokens"] == 3 * sum(traffic["round_gens"])
    assert rec["check_tokens"] == sum(traffic["round_gens"])
    assert rec["mean_gap"] < 0.05


@pytest.mark.parametrize("n", [2, 7, 16])
def test_moe_paths_agree_with_a_plain_loop(n):
    """The reference's MoE, every event's choices grouped by expert with
    each event's own capacity, against one loop over tokens and choices."""
    import math

    import torch.nn.functional as F

    from portbench.harness import common
    from portbench.reference.decoder import Decoder

    cfg = tiny.get("moe")
    arch = common.port_arch(cfg)
    w = common.make_weights(arch, 3, torch.device("cpu"), serving=False)
    dec = Decoder(cfg, w, 1, 8)
    p = w["layers"][1]["mlp"]
    x = torch.randn(n, cfg["hidden_size"], generator=torch.Generator()
                    .manual_seed(n))
    # two events: the second's capacity is its own
    got, again = dec.moe(dec._layer_weights(w["layers"][1]), [x, x[:1]])
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    cap = max(int(cfg["capacity_factor"] * k * n / e), 1)
    probs = torch.softmax(x @ p["router"], -1)
    want = torch.zeros_like(x)
    used = [0] * e
    for i in range(n):
        wts, idx = torch.sort(probs[i], descending=True, stable=True)
        wts, idx = wts[:k] / wts[:k].sum(), idx[:k]
        for wt, j in zip(wts.tolist(), idx.tolist()):
            used[j] += 1
            if used[j] > cap:
                continue
            h = F.silu(x[i] @ p["w_gate"][j]) * (x[i] @ p["w_in"][j])
            want[i] += wt * (h @ p["w_out"][j])
        h = F.silu(x[i] @ p["shared_gate"]) * (x[i] @ p["shared_in"])
        want[i] += h @ p["shared_out"]
    assert math.isclose(float((got - want).abs().max()), 0.0, abs_tol=1e-5)
    assert math.isclose(float((again - dec.moe(
        dec._layer_weights(w["layers"][1]), [x[:1]])[0]).abs().max()), 0.0,
        abs_tol=1e-5)
