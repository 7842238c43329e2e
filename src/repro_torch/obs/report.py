"""Roofline-vs-measured report: modeled bytes over measured phase time
(``repro.obs.report``).

``quant/roofline.py`` models the device bytes a decode phase must move
(decode is memory-bound, so bytes/step IS the cost model); ``PhaseTimer``
measures what the same phases actually took. Dividing the two gives the
*achieved* bytes/s per phase, and — against a peak-bandwidth figure the
caller passes — an achieved-MBU estimate (memory-bandwidth utilization).
On CPU runs the absolute numbers are meaningless; the *ratios between
phases* still locate where the round's time goes relative to where its
bytes go (a draft phase with 10% of the bytes and 40% of the time is
host/dispatch-bound, not bandwidth-bound).
"""
from __future__ import annotations

from typing import Optional

from ..quant.roofline import (decode_step_bytes, drafter_round_bytes,
                              head_round_bytes)
from .phases import PhaseTimer


def attribution_report(timer: PhaseTimer, t_cfg, drafter, batch: int,
                       ctx: int, gamma: int, weights: str = "float32",
                       kv: str = "bfloat16",
                       peak_gbps: Optional[float] = None) -> dict:
    """Per-phase modeled bytes vs measured seconds for chain/tree rounds.

    ``drafter`` is the draft ``ModelConfig`` or a ``draftheads.HeadConfig``
    (duck-typed on ``kind``); ``gamma`` is the sequential draft-step count
    (tree depth for tree rounds). Rows exist only for phases the timer saw.
    """
    rounds = timer.counts.get("verify", timer.counts.get("draft", 0))
    if getattr(drafter, "kind", None) in ("eagle", "medusa"):
        d_bytes = head_round_bytes(drafter, t_cfg, batch, ctx, gamma,
                                   weights).total
    else:
        d_bytes = drafter_round_bytes(drafter, batch, ctx, gamma,
                                      weights, kv).total
    # verify: one target pass over the whole speculation window — weights and
    # context KV are read once regardless of the window width
    v_bytes = decode_step_bytes(t_cfg, batch, ctx, weights, kv).total
    modeled = {"draft": d_bytes, "verify": v_bytes}
    out = {"rounds": rounds, "phases": {}, "peak_gbps": peak_gbps}
    for phase, mb in modeled.items():
        secs = timer.seconds.get(phase)
        if not secs or not rounds:
            continue
        per_round_s = secs / rounds
        achieved = mb / per_round_s / 1e9
        row = {"modeled_bytes_per_round": mb,
               "measured_s_per_round": per_round_s,
               "achieved_gbps": achieved}
        if peak_gbps:
            row["achieved_mbu"] = achieved / peak_gbps
        out["phases"][phase] = row
    return out


def acceptance_report(quality, gamma: int) -> dict:
    """Measured acceptance structure vs the paper's i.i.d.-acceptance model.

    The paper models block efficiency assuming a single per-position
    acceptance rate alpha applied i.i.d. along the chain:
    tau_iid = (1 - alpha^(gamma+1)) / (1 - alpha). Real acceptance is
    *depth-dependent* (drafts compound their own errors, so conditional
    acceptance decays with depth) — this report puts the measured per-depth
    conditional acceptance next to the flat alpha, and the measured tau next
    to the model's prediction.

    ``quality`` is an ``obs.quality.QualityStats``; returns per-depth rows
    plus (tau_measured, tau_iid, alpha).
    """
    att = quality.attempted.astype(float)
    acc = quality.accepted.astype(float)
    tot_att, tot_acc = att.sum(), acc.sum()
    alpha = float(tot_acc / tot_att) if tot_att else float("nan")
    rounds = max(quality.rounds, 1)
    # measured tau: 1 (pending/bonus always commits) + mean accepted/round;
    # survival S(d) = accepted[d-1] / rounds reconstructs it exactly
    tau_meas = 1.0 + float(tot_acc) / rounds
    if alpha == alpha and abs(1.0 - alpha) > 1e-9:
        tau_iid = (1.0 - alpha ** (gamma + 1)) / (1.0 - alpha)
    else:
        tau_iid = float(gamma + 1) if alpha == alpha else float("nan")
    depths = []
    for d in range(quality.depth):
        if att[d] == 0:
            continue
        cond = float(acc[d] / att[d])
        depths.append({"depth": d + 1,
                       "attempted": int(att[d]),
                       "conditional_acceptance": cond,
                       "iid_alpha": alpha,
                       "survival": float(acc[d] / rounds)})
    return {"alpha": alpha, "tau_measured": tau_meas, "tau_iid": tau_iid,
            "gamma": gamma, "rounds": quality.rounds, "depths": depths}


def format_acceptance_report(rep: dict) -> str:
    if not rep["depths"]:
        return "acceptance attribution: no attempted draft positions"
    lines = [(f"acceptance attribution over {rep['rounds']} rounds: "
              f"tau={rep['tau_measured']:.3f} vs i.i.d. model "
              f"{rep['tau_iid']:.3f} (alpha={rep['alpha']:.3f}, "
              f"gamma={rep['gamma']})")]
    for row in rep["depths"]:
        delta = row["conditional_acceptance"] - row["iid_alpha"]
        lines.append(
            f"  depth {row['depth']}: accept|reached="
            f"{row['conditional_acceptance']:.3f} ({delta:+.3f} vs alpha) "
            f"survival={row['survival']:.3f} n={row['attempted']}")
    return "\n".join(lines)


def format_attribution(rep: dict) -> str:
    if not rep["phases"]:
        return "roofline-vs-measured: no timed device phases"
    lines = [f"roofline-vs-measured over {rep['rounds']} rounds:"]
    for phase, r in rep["phases"].items():
        line = (f"  {phase}: modeled {r['modeled_bytes_per_round'] / 1e6:.2f} "
                f"MB/round over {r['measured_s_per_round'] * 1e3:.2f} ms/round"
                f" -> {r['achieved_gbps']:.3f} GB/s achieved")
        if "achieved_mbu" in r:
            line += f" (MBU {r['achieved_mbu']:.1%} of {rep['peak_gbps']} GB/s)"
        lines.append(line)
    return "\n".join(lines)
