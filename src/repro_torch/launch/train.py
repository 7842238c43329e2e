"""Training launcher of the port (``repro.launch.train``): pretraining of the
arch, or distillation of a drafter against it, on the synthetic corpus, on
the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b-chat \
      --reduced --steps 50 --phase pretrain
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b-chat \
      --reduced --steps 50 --phase distill --loss tvdpp

``--phase distill`` fine-tunes the arch's drafter (with ``--reduced``: the
reduced arch with half its layers, as the reference builds it) against the
arch's randomly initialised target; only the target's parameters are built,
since the frozen target takes no optimizer step. ``--save`` writes the
trained parameters with ``checkpoint.save``.

``--draft-head {eagle,medusa}`` distills self-speculative draft heads
instead of a drafter (``repro_torch.draftheads``): the target answers
``--datagen-seqs`` corpus seeds (``core.datagen``, temperatures 0 and 0.7),
those responses are mixed 9:1 with the pretraining chunks, and the heads
train against the target's live hidden states; ``--save`` then writes a
head checkpoint (``checkpoint.save_draft_heads``) that ``launch.serve
--draft-head ... --head-ckpt`` loads:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b-chat \
      --reduced --steps 50 --draft-head eagle --save heads.npz

``--arch`` takes every key of ``configs.ARCHS``; an MoE target's loss adds
its router aux (``loss_ce``), and the recurrent archs (``zamba2-7b``,
``xlstm-1.3b``) train through their chunked scans. ``musicgen-large``
pretrains with its four codebooks on the stream replicated per codebook,
as the reference does; its ``--phase distill`` exits with the refusal of
``training.finetune.check_distillable`` (ROADMAP §3 item 11) and its
``--draft-head`` with the reference's message, before anything is built.

The synthetic corpus holds six V x V float64 transition matrices, so a
full-width vocabulary (Llama-2's 32000: 49 GB) is refused; ``--reduced``
cuts it to 512.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint.io import save, save_draft_heads
from ..configs import ARCHS, get_config, reduced
from ..configs.base import TrainConfig
from ..core.datagen import DatagenConfig, generate_distillation_dataset
from ..data import SyntheticCorpus, mixed_batches, pack_documents, simple_batches
from ..draftheads import (HeadConfig, HeadDrafter, finetune_heads,
                          make_head_train_state)
from ..models.model import Model
from ..models.transformer import check_config
from ..training import finetune, make_train_state, train
from ..training.finetune import check_distillable

# host memory the corpus's transition matrices may take
CORPUS_MAX_BYTES = 2 << 30


def corpus_bytes(vocab_size: int) -> int:
    """Bytes of ``SyntheticCorpus``'s six float64 transition matrices."""
    return 6 * 8 * (vocab_size - 3) ** 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--phase", choices=("pretrain", "distill"), default="pretrain")
    ap.add_argument("--loss", default="tvdpp",
                    choices=("kld", "kld_bwd", "jsd", "tvd", "tvdpp"))
    ap.add_argument("--draft-head", choices=("eagle", "medusa"), default=None,
                    help="distill self-speculative draft heads instead of a "
                         "drafter (implies --phase distill)")
    ap.add_argument("--medusa-heads", type=int, default=4,
                    help="number of parallel Medusa heads (offsets +1..+K)")
    ap.add_argument("--datagen-seqs", type=int, default=8,
                    help="seed sequences of the datagen distillation set "
                         "(--draft-head only)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.num_codebooks > 1 and args.draft_head is not None:
        raise SystemExit("--draft-head supports single-codebook targets")
    try:        # a config the port cannot run exits with its reason
        check_config(cfg)
        if args.phase == "distill":
            check_distillable(cfg)
    except ValueError as e:
        raise SystemExit(str(e))
    if corpus_bytes(cfg.vocab_size) > CORPUS_MAX_BYTES:
        raise SystemExit(
            f"{cfg.name}: the synthetic corpus would take "
            f"{corpus_bytes(cfg.vocab_size) / 1e9:.1f} GB of host memory at "
            f"vocab {cfg.vocab_size}; pass --reduced")
    model = Model(cfg, args.device)
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps, batch_size=args.batch,
                     seq_len=args.seq)

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=args.seed)
    chunks = pack_documents(corpus.pretrain_docs(600, args.seq * 2), args.seq)
    if cfg.num_codebooks > 1:   # audio: the stream replicated per codebook
        chunks = np.repeat(chunks[:, None, :], cfg.num_codebooks, axis=1)
    t0 = time.time()
    if args.draft_head is not None:
        train_heads(args, model, chunks, tc, t0)
        return
    if args.phase == "pretrain":
        state = make_train_state(model, args.seed, tc)
        state, _ = train(model, state, simple_batches(chunks, args.batch),
                         tc, args.steps, log_every=max(args.steps // 5, 1),
                         callback=lambda s, m: print(f"step {s}: {m}"))
    else:
        d_cfg = cfg.drafter() if not args.reduced else cfg.replace(
            name=cfg.name + "-draft", num_layers=max(cfg.num_layers // 2, 1))
        draft = Model(d_cfg, args.device)
        t_params = model.init(args.seed, dtype=getattr(torch, cfg.param_dtype))
        state = make_train_state(draft, args.seed + 1, tc)
        state, _ = finetune(
            draft, model, state, t_params,
            mixed_batches(chunks, chunks, args.batch, mix=tc.distill_mix),
            tc, args.steps, loss_kind=args.loss,
            log_every=max(args.steps // 5, 1),
            callback=lambda s, m: print(f"step {s}: {m}"))
    print(f"done in {time.time() - t0:.1f}s")
    if args.save:
        save(args.save, state["params"])
        print(f"saved params -> {args.save}")


def train_heads(args, model, chunks, tc, t0):
    """Distill draft heads against the arch's seeded float32 target on
    target-generated responses mixed 9:1 with ``chunks``."""
    cfg = model.cfg
    drafter = HeadDrafter(HeadConfig.for_target(
        args.draft_head, cfg, num_medusa_heads=args.medusa_heads))
    t_params = model.init(args.seed, dtype=getattr(torch, cfg.param_dtype))
    seed_len = max(args.seq // 2, 1)
    seeds = np.asarray(chunks[:args.datagen_seqs, :seed_len])
    data = generate_distillation_dataset(
        model, t_params, seeds,
        DatagenConfig(temperatures=(0.0, 0.7),
                      max_response_tokens=args.seq - seed_len,
                      batch_size=args.datagen_seqs),
        gen=torch.Generator(device=model.device).manual_seed(args.seed))
    state = make_head_train_state(drafter, args.seed + 1, model.device)
    state, _ = finetune_heads(
        drafter, model, state, t_params,
        mixed_batches(data, chunks, args.batch, mix=tc.distill_mix),
        tc, args.steps, loss_kind=args.loss, log_every=max(args.steps // 5, 1),
        callback=lambda s, m: print(f"step {s}: {m}"))
    print(f"done in {time.time() - t0:.1f}s ({args.draft_head} heads, "
          f"{drafter.hc.param_count()} params)")
    if args.save:
        save_draft_heads(args.save, drafter, state["params"])
        print(f"saved {args.draft_head} head params -> {args.save}")


if __name__ == "__main__":
    main()
