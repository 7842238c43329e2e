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

The synthetic corpus holds six V x V float64 transition matrices, so a
full-width vocabulary (Llama-2's 32000: 49 GB) is refused; ``--reduced``
cuts it to 512.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint.io import save
from ..configs import ARCHS, get_config, reduced
from ..configs.base import TrainConfig
from ..data import SyntheticCorpus, mixed_batches, pack_documents, simple_batches
from ..models.model import Model
from ..training import finetune, make_train_state, train

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
    t0 = time.time()
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


if __name__ == "__main__":
    main()
