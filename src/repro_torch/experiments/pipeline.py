"""The paper's full pipeline at small scale (``repro.experiments.pipeline``).

Phases (paper 2): (1) pretrain the target ("chat" model) and the drafter
from scratch on the synthetic corpus, then chat-SFT the target;
(2) distillation data generated by the *target* at temperatures
{0, .3, .7, 1.0}, top-p .95; (3) drafter fine-tuning with {KLD, TVD, TVD++}
against the frozen target, 9:1 distill:pretrain mixing.

Evaluation mirrors the paper: block efficiency tau and MBSU on dolly
(sampled, temp .6 / top-p .9), cnndm and xsum (greedy), gamma in {3, 5},
across fine-tuning checkpoints (fig 2), the WMT OOD study (fig 3 / A.5),
and the measured SD-vs-AR token-rate ratio.

  PYTHONPATH=src python -m repro_torch.experiments.pipeline \
      [--quick] [--device cpu] [--out result.json]

runs it with the reference's defaults (``--quick``: the sizes of the
reference's ``benchmarks/repro_pipeline.py --quick``) and prints the result.

Scale knobs are arguments, with the reference's defaults. Every model,
tensor and random draw lives on ``device`` (the card unless the caller asks
for the CPU); random draws come from ``torch.Generator``s seeded as the
reference seeds its keys, so the numbers follow the same recipe but not the
same draws. Like the reference, fine-tuning takes the plain loss route
(``finetune`` without ``use_kernels``). The token-rate ratio divides wall
times of eager rounds, so on the card it measures the host's dispatch as
much as the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..core.datagen import DatagenConfig, generate_distillation_dataset
from ..core.metrics import mbsu
from ..core.speculative import (SDConfig, autoregressive_generate,
                                speculative_generate)
from ..data import (TASKS, SyntheticCorpus, mixed_batches, pack_documents,
                    simple_batches)
from ..launch.serve import count_params
from ..models.model import Model
from ..training import finetune, make_train_state, train

VOCAB = 128
SEQ = 64


def target_config() -> ModelConfig:
    return ModelConfig(name="target-chat", arch_type="dense", num_layers=6,
                       d_model=192, num_heads=6, num_kv_heads=2, head_dim=32,
                       d_ff=384, vocab_size=VOCAB, attn_chunk=32, remat=False)


def draft_config() -> ModelConfig:
    return ModelConfig(name="drafter", arch_type="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                       d_ff=128, vocab_size=VOCAB, attn_chunk=32, remat=False)


@dataclass
class ReproResult:
    c_ratio: float = 0.0
    pretrain_ce: Dict[str, float] = field(default_factory=dict)
    # tau[loss][task][gamma] at the final checkpoint; loss includes "base"
    tau: Dict = field(default_factory=dict)
    mbsu: Dict = field(default_factory=dict)
    # fig2: tau over checkpoints, gamma=3
    tau_by_ckpt: Dict = field(default_factory=dict)
    ood: Dict = field(default_factory=dict)
    token_rate_ratio: Dict = field(default_factory=dict)
    wall_s: float = 0.0


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _eval_tau(draft, target, d_params, t_params, corpus, task, gamma,
              temperature, top_p, n_prompts, max_new, seed=7):
    prompts = torch.as_tensor(corpus.instructions(n_prompts, 12, task, seed=seed),
                              dtype=torch.long, device=target.device)
    sdc = SDConfig(gamma=gamma, temperature=temperature, top_p=top_p)
    _, stats = speculative_generate(draft, target, d_params, t_params,
                                    prompts, max_new, sdc,
                                    gen=_gen(target.device, seed))
    return stats


TASK_DECODING = {"dolly": (0.6, 0.9), "cnndm": (0.0, 1.0), "xsum": (0.0, 1.0),
                 "wmt": (0.0, 1.0)}


def run_pipeline(pretrain_steps=500, draft_pretrain_steps=900,
                 finetune_steps=400, ckpt_every=None, n_seeds_per_task=8,
                 eval_prompts=8, eval_new_tokens=48, losses=("kld", "tvd", "tvdpp"),
                 gammas=(3, 5), batch=16, verbose=True,
                 concentration=0.08, sft_steps=250, device="cuda") -> ReproResult:
    t_start = time.time()
    log = print if verbose else (lambda *a, **k: None)
    res = ReproResult()
    ckpt_every = ckpt_every or max(finetune_steps // 4, 1)

    # peaky bigram language: enough learnable structure that a well-trained
    # drafter can anticipate the target (block efficiency headroom)
    corpus = SyntheticCorpus(vocab_size=VOCAB, seed=0,
                             concentration=concentration)
    chunks = pack_documents(corpus.pretrain_docs(800, 2 * SEQ), SEQ)

    target = Model(target_config(), device)
    draft = Model(draft_config(), device)
    tc = TrainConfig(learning_rate=3e-3, min_learning_rate=3e-4,
                     warmup_steps=30, total_steps=pretrain_steps,
                     batch_size=batch, seq_len=SEQ)

    # ---- phase 1: pretraining ----------------------------------------------
    log("[1/4] pretraining target + draft ...")
    tstate = make_train_state(target, 0, tc)
    tstate, th = train(target, tstate, simple_batches(chunks, batch), tc,
                       pretrain_steps, log_every=pretrain_steps // 2)
    dstate0 = make_train_state(draft, 1, tc)
    dstate0, dh = train(draft, dstate0, simple_batches(chunks, batch, seed=3),
                        tc, draft_pretrain_steps,
                        log_every=draft_pretrain_steps // 2)
    res.pretrain_ce = {"target": th[-1]["ce"], "draft": dh[-1]["ce"]}
    res.c_ratio = count_params(dstate0["params"]) / count_params(tstate["params"])
    log(f"  target ce={th[-1]['ce']:.3f} draft ce={dh[-1]['ce']:.3f} "
        f"c={res.c_ratio:.4f}")

    # ---- phase 1.5: chat-SFT the target --------------------------------------
    # The paper's targets are chat-fine-tuned: their generation distribution
    # differs from the pretraining corpus (the gap that draft alignment
    # closes). The target is SFT'd on instruction -> chat-style responses;
    # the drafter stays pretrain-only.
    log("[1.5/4] chat-SFT of the target ...")
    sft_docs = [d for t in TASKS for d in corpus.chat_sft_docs(150, t)]
    sft_chunks = pack_documents(sft_docs, SEQ)
    sft_tc = TrainConfig(learning_rate=1e-3, min_learning_rate=1e-4,
                         warmup_steps=10, total_steps=sft_steps,
                         batch_size=batch, seq_len=SEQ)
    tstate, sh = train(target, tstate, simple_batches(sft_chunks, batch, seed=7),
                       sft_tc, sft_steps, log_every=max(sft_steps // 2, 1))
    log(f"  target sft ce={sh[-1]['ce']:.3f}")

    # ---- phase 2: distillation dataset (the target generates) ---------------
    log("[2/4] generating distillation dataset (temps 0/.3/.7/1.0, top-p .95)")
    seeds = np.concatenate([corpus.instructions(n_seeds_per_task, 12, t, seed=2)
                            for t in TASKS])
    dg = generate_distillation_dataset(
        target, tstate["params"], seeds,
        DatagenConfig(max_response_tokens=32, batch_size=24),
        gen=_gen(device, 0))
    distill_chunks = pack_documents(list(dg), SEQ)
    log(f"  {dg.shape[0]} responses -> {distill_chunks.shape[0]} chunks")

    # ---- phase 3: fine-tuning with each loss ---------------------------------
    ftc = TrainConfig(learning_rate=1e-3, min_learning_rate=1e-4,
                      warmup_steps=20, total_steps=finetune_steps,
                      batch_size=batch)
    ckpts: Dict[str, List] = {}
    for loss in losses:
        log(f"[3/4] fine-tuning draft with {loss} ...")
        state = dstate0          # steps return new tensors: dstate0 is kept
        saved = []
        done = 0
        while done < finetune_steps:
            n = min(ckpt_every, finetune_steps - done)
            state, _ = finetune(
                draft, target, state, tstate["params"],
                mixed_batches(distill_chunks, chunks, batch, mix=0.9,
                              seed=done), ftc, n, loss_kind=loss)
            done += n
            saved.append((done, state["params"]))
        ckpts[loss] = saved

    # ---- phase 4: evaluation ---------------------------------------------------
    log("[4/4] evaluating block efficiency / MBSU / token rate ...")
    c = res.c_ratio

    def ev(d_params, task, gamma):
        temp, top_p = TASK_DECODING[task]
        return _eval_tau(draft, target, d_params, tstate["params"], corpus,
                         task, gamma, temp, top_p, eval_prompts,
                         eval_new_tokens)

    variants = {"base": dstate0["params"]}
    for loss in losses:
        variants[loss] = ckpts[loss][-1][1]

    for name, dp in variants.items():
        res.tau[name], res.mbsu[name] = {}, {}
        for task in TASKS:
            res.tau[name][task], res.mbsu[name][task] = {}, {}
            for gamma in gammas:
                s = ev(dp, task, gamma)
                res.tau[name][task][str(gamma)] = round(s.tau, 4)
                res.mbsu[name][task][str(gamma)] = round(mbsu(s.tau, c, gamma), 4)
        log(f"  {name}: " + " ".join(
            f"{t}(g3)={res.tau[name][t]['3']:.2f}" for t in TASKS
            if "3" in res.tau[name][t]))

    # fig 2: checkpoints, gamma=3
    for loss in losses:
        res.tau_by_ckpt[loss] = {}
        for task in TASKS:
            res.tau_by_ckpt[loss][task] = [
                (step, round(ev(p, task, 3).tau, 4))
                for step, p in ckpts[loss]]

    # fig 3 / A.5: OOD (wmt), base vs fine-tuned
    for name, dp in variants.items():
        s = ev(dp, "wmt", 3)
        res.ood[name] = round(s.tau, 4)

    # token-rate ratio (wall clock of eager rounds): SD vs AR on dolly
    tvpp = variants.get("tvdpp", variants[list(variants)[-1]])
    prompts = torch.as_tensor(corpus.instructions(eval_prompts, 12, "dolly", seed=11),
                              dtype=torch.long, device=target.device)
    for gamma in gammas:
        sdc = SDConfig(gamma=gamma, temperature=0.6, top_p=0.9)
        _, st = speculative_generate(draft, target, tvpp, tstate["params"],
                                     prompts, eval_new_tokens, sdc,
                                     gen=_gen(device, 0))
        _, ar_dt = autoregressive_generate(target, tstate["params"], prompts,
                                           eval_new_tokens, 0.6, 0.9,
                                           gen=_gen(device, 0))
        sd_rate = st.total_tokens / max(st.wall_time_s, 1e-9)
        ar_rate = (eval_prompts * eval_new_tokens) / max(ar_dt, 1e-9)
        res.token_rate_ratio[str(gamma)] = round(sd_rate / ar_rate, 3)

    res.wall_s = round(time.time() - t_start, 1)
    return res


def save_result(res: ReproResult, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(res), f, indent=1)


# the sizes of the reference's ``benchmarks/repro_pipeline.py --quick``
QUICK = dict(pretrain_steps=60, draft_pretrain_steps=40, finetune_steps=30,
             ckpt_every=10, n_seeds_per_task=4, eval_prompts=3,
             eval_new_tokens=16, sft_steps=20)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args(argv)
    res = run_pipeline(device=args.device, **(QUICK if args.quick else {}))
    if args.out:
        save_result(res, args.out)
    print(json.dumps(dataclasses.asdict(res)))


if __name__ == "__main__":
    main()
