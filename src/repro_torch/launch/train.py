"""Training launcher of the port: the LM trained on batches of the
OnPair-compressed corpus, whose dictionary is the vocabulary, through the
fault-tolerant loop (resume from the latest checkpoint, preemption, async
checkpoints)::

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch mamba2-780m --steps 8 --batch 8 --seq 256 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 4 --batch 2 --seq 32

  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --device cpu --mesh 2,2

It runs on the card unless ``--device cpu`` is given; without CUDA and
without ``--device cpu`` it exits non-zero before it builds anything. The
model's vocabulary is the tokenizer's (65,539 ids) at every width: the
batches carry ids up to 65,538, past the configs' own vocabularies. The
weights are random (seed 0) and the step runs eagerly.

``--mesh data,model`` trains on a ``DeviceMesh`` of that shape
(:mod:`repro_torch.train.mesh_step`): one process per device, started by
``torch.distributed.run`` (NCCL on the card, each rank on the card of its
``LOCAL_RANK``; gloo with ``--device cpu``); ``--mesh 1,1`` also runs in
one plain process. ``data * model`` must equal the number of processes.
The state is placed by ``state_shardings`` (FSDP when the bf16 parameters
pass 8 GB, the dry-run's rule), and rank 0 alone prints, writes the
checkpoints and the ``--stats-json``.
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
                    help="data,model axis sizes (default: one device); "
                         "data * model processes")
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
    from repro_torch.train.state import (make_abstract_state, make_state,
                                         state_shardings)
    from repro_torch.train.train_step import make_train_step

    dev = resolve_device(device)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_host_mesh, parse_mesh

        mesh = make_host_mesh(*parse_mesh(args.mesh), device_type=dev.type)
    say = print if mesh is None or mesh.get_rank() == 0 else (lambda *a, **k: None)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()

    # ---- data plane: OnPair-compressed corpus + OnPair tokenizer ----------
    strings = load_dataset(args.data, args.data_mib << 20)
    store = CompressedCorpusStore.build(strings, sample_bytes=2 << 20)
    say(f"corpus: {store.n_docs} docs, ratio {store.compression_ratio:.2f}x,"
        f" resident {store.memory_bytes / (1 << 20):.1f} MiB compressed",
        flush=True)
    pipe = TokenPipeline(store, BatchSpec(global_batch=args.batch,
                                          seq_len=args.seq, seed=0))
    # the OnPair dictionary is the vocabulary, at every width
    cfg = replace(cfg, vocab_size=store.tokenizer.vocab_size)
    say(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
        f"(smoke={args.smoke}, vocab {cfg.vocab_size}, {dev}"
        + (f", mesh {args.mesh}" if mesh is not None else "") + ")", flush=True)

    # ---- model/optimizer ---------------------------------------------------
    opt = AdamWConfig(lr=args.lr)
    state = make_state(cfg, opt, seed=0, device=dev)
    abstract = make_abstract_state(cfg, opt)
    shardings = None
    if mesh is None:
        step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                                  schedule_total=args.steps)
    else:
        from repro_torch.distributed.sharding import place_tree
        from repro_torch.train.mesh_step import make_mesh_train_step

        shardings = state_shardings(abstract, mesh, cfg,
                                    fsdp=cfg.n_params() * 2 > 8e9)
        state = place_tree(state, shardings)
        step_fn = make_mesh_train_step(cfg, opt, mesh, shardings,
                                       microbatches=args.microbatches,
                                       schedule_total=args.steps)

    def batch_fn(step: int) -> dict:
        b = pipe.batch(step)
        return {k: torch.from_numpy(b[k]).to(dev) for k in ("tokens", "targets")}

    loop = TrainLoop(step_fn, state, batch_fn,
                     LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                                ckpt_dir=args.ckpt_dir, log_every=10),
                     abstract_state=abstract, device=dev,
                     install_signals=install_signals, shardings=shardings)
    stats = loop.run(log=say)
    if stats.losses:
        say(f"done: {stats.steps_run} steps, resumed_from={stats.resumed_from}, "
            f"loss {stats.losses[0]:.3f} -> {stats.losses[-1]:.3f}, "
            f"stragglers={stats.straggler_steps}", flush=True)
    else:
        say(f"done: 0 steps, resumed_from={stats.resumed_from}", flush=True)
    return {"cfg": cfg, "store": store, "pipe": pipe, "step_fn": step_fn,
            "batch_fn": batch_fn, "loop": loop, "mesh": mesh,
            "shardings": shardings}


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh

        try:
            d, m = parse_mesh(args.mesh)
        except ValueError as exc:
            ap.error(str(exc))
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if d * m != world:
            ap.error(f"--mesh {args.mesh} needs {d * m} processes, one per "
                     f"device; this launch has {world} (start it with python -m "
                     f"torch.distributed.run --nproc-per-node {d * m})")

    from contextlib import nullcontext

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import process_group

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        ap.exit(1, f"{ap.prog}: {exc}\n")
    with process_group(dev) if args.mesh else nullcontext():
        out = train_lm(args, dev)
        writer = out["mesh"] is None or out["mesh"].get_rank() == 0
        if args.stats_json and writer:
            stats, cfg = out["loop"].stats, out["cfg"]
            with open(args.stats_json, "w") as f:
                json.dump({"arch": cfg.name, "vocab_size": cfg.vocab_size,
                           "n_params": cfg.n_params(), "steps_run": stats.steps_run,
                           "resumed_from": stats.resumed_from,
                           "preempted": stats.preempted,
                           "straggler_steps": stats.straggler_steps,
                           "losses": stats.losses, "step_times": stats.step_times,
                           "mesh": args.mesh}, f)


if __name__ == "__main__":
    main()
