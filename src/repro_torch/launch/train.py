"""Training launcher of the port: the LM trained on batches of the
OnPair-compressed corpus, whose dictionary is the vocabulary, through the
fault-tolerant loop (resume from the latest checkpoint, preemption, async
checkpoints)::

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch mamba2-780m --steps 8 --batch 8 --seq 256 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 4 --batch 2 --seq 32

It runs on the card unless ``--device cpu`` is given; without CUDA and
without ``--device cpu`` it exits non-zero before it builds anything. The
model's vocabulary is the tokenizer's (65,539 ids) at every width: the
batches carry ids up to 65,538, past the configs' own vocabularies. The
weights are random (seed 0) and the step runs eagerly. ``--mesh`` is
refused: sharding waits for a later slice of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--data", default="book_titles")
    ap.add_argument("--data-mib", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="",
                    help="data,model axis sizes: refused until the port "
                         "shards the model")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: the card)")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="also write the run's stats (every loss and step "
                         "time, the resume step, preemption) to PATH as JSON")
    return ap


def train_lm(args: argparse.Namespace, device, install_signals: bool = True) -> dict:
    """Build the data plane, the state and the step, and run the loop,
    printing the reference launcher's lines. Returns the config trained,
    the corpus store, the pipeline, the step function, the batch function
    and the loop (its ``state`` and ``stats`` as the run left them)."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.corpus import CompressedCorpusStore
    from repro_torch.data.pipeline import BatchSpec, TokenPipeline
    from repro_torch.data.synth import load_dataset
    from repro_torch.device import resolve_device
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.train.state import make_abstract_state, make_state
    from repro_torch.train.train_step import make_train_step

    dev = resolve_device(device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()

    # ---- data plane: OnPair-compressed corpus + OnPair tokenizer ----------
    strings = load_dataset(args.data, args.data_mib << 20)
    store = CompressedCorpusStore.build(strings, sample_bytes=2 << 20)
    print(f"corpus: {store.n_docs} docs, ratio {store.compression_ratio:.2f}x,"
          f" resident {store.memory_bytes / (1 << 20):.1f} MiB compressed",
          flush=True)
    pipe = TokenPipeline(store, BatchSpec(global_batch=args.batch,
                                          seq_len=args.seq, seed=0))
    # the OnPair dictionary is the vocabulary, at every width
    cfg = replace(cfg, vocab_size=store.tokenizer.vocab_size)
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"(smoke={args.smoke}, vocab {cfg.vocab_size}, {dev})", flush=True)

    # ---- model/optimizer ---------------------------------------------------
    opt = AdamWConfig(lr=args.lr)
    state = make_state(cfg, opt, seed=0, device=dev)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                              schedule_total=args.steps)

    def batch_fn(step: int) -> dict:
        b = pipe.batch(step)
        return {k: torch.from_numpy(b[k]).to(dev) for k in ("tokens", "targets")}

    loop = TrainLoop(step_fn, state, batch_fn,
                     LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                                ckpt_dir=args.ckpt_dir, log_every=10),
                     abstract_state=make_abstract_state(cfg, opt), device=dev,
                     install_signals=install_signals)
    stats = loop.run()
    if stats.losses:
        print(f"done: {stats.steps_run} steps, resumed_from={stats.resumed_from}, "
              f"loss {stats.losses[0]:.3f} -> {stats.losses[-1]:.3f}, "
              f"stragglers={stats.straggler_steps}", flush=True)
    else:
        print(f"done: 0 steps, resumed_from={stats.resumed_from}", flush=True)
    return {"cfg": cfg, "store": store, "pipe": pipe, "step_fn": step_fn,
            "batch_fn": batch_fn, "loop": loop}


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("--mesh waits for the port's sharding slice "
                 "(distributed/sharding.py); the port trains on one device")

    from repro_torch.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        ap.exit(1, f"{ap.prog}: {exc}\n")
    out = train_lm(args, dev)
    if args.stats_json:
        stats, cfg = out["loop"].stats, out["cfg"]
        with open(args.stats_json, "w") as f:
            json.dump({"arch": cfg.name, "vocab_size": cfg.vocab_size,
                       "n_params": cfg.n_params(), "steps_run": stats.steps_run,
                       "resumed_from": stats.resumed_from,
                       "preempted": stats.preempted,
                       "straggler_steps": stats.straggler_steps,
                       "losses": stats.losses, "step_times": stats.step_times}, f)


if __name__ == "__main__":
    main()
