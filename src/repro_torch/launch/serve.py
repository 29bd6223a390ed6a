"""Serving launcher of the port: batched prefill + decode of an LM whose
vocabulary is an OnPair dictionary, with prompts fetched from the
OnPair-compressed corpus store; or a shard server.

Prompts can come from the command line or straight out of the compressed
corpus store (``--doc-ids``): the corpus lives in memory compressed (built
through the encode kernel), and prompt materialisation is one store
multiget, which on the card is one launch of the decode kernel. The LM runs
on the card unless ``--device cpu`` is given; without CUDA and without
``--device cpu`` the launcher exits non-zero before it builds anything::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --doc-ids 3 17 4242 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --smoke \\
      --prompts "the quick" "compression" --max-new 16 --device cpu

The weights are random (seed 0): the configs are shapes. ``--shard-server``
flips the launcher into its other role, a per-shard RPC server process for
the multi-process serving tier (:mod:`repro_torch.net`), with no LM::

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --shard-server /data/corpus/shard-0002 --port 9102

It prints the ``SHARD_SERVER_READY port=<p> ...`` line of ``python -m
repro_torch.net`` and serves until interrupted.
"""

from __future__ import annotations

import argparse
import time

#: the corpus the tokenizer is trained on and the in-process store holds
#: when no --store-dir is given
CORPUS_BYTES = 1 << 20


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--shard-server", default=None, metavar="SHARD_DIR",
                    help="serve this shard directory (<dir>/shard-000k) over "
                         "TCP via repro_torch.net.shard_server and exit when "
                         "interrupted; skips the LM entirely")
    ap.add_argument("--host", default="127.0.0.1",
                    help="--shard-server bind host")
    ap.add_argument("--port", type=int, default=0,
                    help="--shard-server bind port (0 = kernel-assigned)")
    ap.add_argument("--read-only", action="store_true",
                    help="--shard-server: serve as a read-only replica")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="also serve Prometheus /metrics + the /traces "
                         "slow-request dump on this port (0 = "
                         "kernel-assigned); applies to both roles")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced same-family config")
    ap.add_argument("--prompts", nargs="+",
                    default=["the quick brown", "in memory database"])
    ap.add_argument("--doc-ids", type=int, nargs="*", default=None,
                    help="additionally serve prompts fetched by id from the "
                         "OnPair-compressed corpus store (repro_torch.store)")
    ap.add_argument("--store-dir", default=None,
                    help="open a persisted CompressedStringStore (built with "
                         "store.save(dir)) instead of compressing in-process; "
                         "the store's saved dictionary artifact becomes the "
                         "tokenizer vocabulary")
    ap.add_argument("--writable", action="store_true",
                    help="open --store-dir as a MutableStringStore (accepts "
                         "appends against the frozen dictionary; versioned "
                         "directory layout)")
    ap.add_argument("--append", nargs="*", default=None, metavar="DOC",
                    help="append these documents to the writable store "
                         "before serving (their new ids are also served as "
                         "prompts); prints the drift snapshot")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the LM and the store's kernels run (default: "
                         "the card; cpu runs torch on the host and the "
                         "kernels' plain PyTorch versions)")
    return ap


def _open_store_client(store_dir: str, writable: bool, device):
    """A client over a saved store: writable (``mut://``) or read-only
    (``file://``), on ``device`` when its codec has a kernel, else on the
    host as that codec always runs."""
    from repro_torch.client import connect
    from repro_torch.core import registry
    from repro_torch.store import CompressedStringStore

    meta = CompressedStringStore._read_meta(
        CompressedStringStore._resolve_current(store_dir))
    opts = {"device": device} if registry.capabilities(
        meta["codec"]).device_decodable else {}
    return connect(f"{'mut' if writable else 'file'}://{store_dir}", **opts)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def serve_lm(args: argparse.Namespace, device) -> dict:
    """The LM role: tokenizer, store, prompts, random weights (seed 0),
    prefill and ``args.max_new`` greedy decode steps, printing the reference
    launcher's lines.

    Returns the config served, the prompts (display strings), the documents
    fetched, the prompt token ids, the padded token batch, the generated ids
    (B, max_new), whether every logit of prefill and decode was finite, the
    prefill and decode seconds (the card synchronised before each clock
    read), and the weights and the decode cache as the last step left them.
    """
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tokenizer import OnPairTokenizer
    from repro_torch.data.synth import load_dataset
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_params, serve_decode, serve_prefill

    dev = resolve_device(device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()

    client = None
    corpus_strings = None
    prompts = list(args.prompts)
    doc_ids = list(args.doc_ids) if args.doc_ids else []
    docs: list[bytes] = []
    try:
        if args.store_dir:
            # persisted-store path through the client layer: the saved
            # dictionary artifact IS the vocab — nothing is retrained
            from repro_torch.core import registry

            client = _open_store_client(args.store_dir, args.writable, dev)
            codec = registry.resolve(client.backend.artifact.codec)
            if codec not in ("onpair", "onpair16"):
                raise SystemExit(
                    f"--store-dir: store was built with codec {codec!r}; the "
                    "LM tokenizer vocabulary is an OnPair dictionary — "
                    "rebuild the store with codec='onpair16'")
            tok = OnPairTokenizer.from_artifact(client.backend.artifact)
        else:
            # OnPair tokenizer trained on a small corpus (vocab == dictionary)
            corpus_strings = load_dataset("book_titles", CORPUS_BYTES)
            tok = OnPairTokenizer.train(corpus_strings, sample_bytes=CORPUS_BYTES)
        cfg = replace(cfg, vocab_size=tok.vocab_size)
        params = build_params(cfg, seed=0, device=dev)

        if args.append:
            # ingest path: parse new docs against the store's frozen dictionary
            if client is None or not args.writable:
                raise SystemExit("--append requires --store-dir with --writable")
            new_ids = client.extend([d.encode() for d in args.append])
            client.save()  # ingest is durable, not in-memory only
            drift = client.backend.drift.snapshot()
            print(f"appended {len(new_ids)} docs (ids {new_ids[0]}..{new_ids[-1]}), "
                  f"tail {client.stats()['backend']['n_tail_strings']} strings, "
                  f"saved to {args.store_dir}, drift {drift['drift']:.3f} "
                  f"(compact recommended: {drift['should_compact']})", flush=True)
            doc_ids += new_ids

        prompt_bytes = [p.encode() for p in prompts]
        if doc_ids:
            # corpus path: the store answers the prompt fetch as one batched
            # kernel decode over the compressed payload
            if client is None:
                from repro_torch.client import wrap
                from repro_torch.core.codec import Encoder
                from repro_torch.store import CompressedStringStore

                artifact = tok.to_artifact()
                client = wrap(CompressedStringStore(
                    artifact, Encoder(artifact, device=dev).encode(corpus_strings),
                    device=dev))
            docs = client.multiget(doc_ids)
            prompt_bytes += docs
            # display names only; latin-1 roundtrips arbitrary doc bytes
            prompts += [d.decode("latin-1") for d in docs]
            snap = client.stats()["backend"]
            print(f"store: {snap['n_strings']} docs in {snap['n_segments']} "
                  f"segments ({snap['backend']} backend), fetched "
                  f"{len(docs)} prompts, jit shapes {snap['jit_shapes']}",
                  flush=True)
    finally:
        if client is not None:
            client.close()

    ids = tok.encode_batch(prompt_bytes, bos=True)
    L = max(len(s) for s in ids)
    # right-padded with id 0, a real token (not PAD_ID), as the reference
    tokens = np.zeros((len(ids), L), np.int32)
    for i, s in enumerate(ids):
        tokens[i, : len(s)] = s

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = serve_prefill(
            params, {"tokens": torch.from_numpy(tokens).to(dev)}, cfg,
            max_seq=args.max_seq)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        print(f"prefill: {tuple(tokens.shape)} in {prefill_s:.2f}s", flush=True)
        finite = torch.isfinite(logits).all()
        outs = [list(map(int, s)) for s in ids]
        tok_ids = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(args.max_new):
            for i, t in enumerate(tok_ids[:, 0].tolist()):
                outs[i].append(int(t))
            logits, cache = serve_decode(params, cache, {"token": tok_ids}, cfg)
            finite = finite & torch.isfinite(logits).all()
            tok_ids = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    n_tok = args.max_new * len(prompts)
    print(f"decode: {n_tok} tokens in {decode_s:.2f}s "
          f"({n_tok / decode_s:.1f} tok/s, untrained weights)", flush=True)
    for prompt, seq in zip(prompts, outs):
        text = tok.decode(np.asarray(seq))
        print(f"  {prompt!r} -> {text[:80]!r}", flush=True)
    generated = np.asarray([o[len(s):] for o, s in zip(outs, ids)], np.int64)
    return {"cfg": cfg, "prompts": prompts, "docs": docs, "ids": ids,
            "tokens": tokens, "generated": generated.reshape(len(ids), -1),
            "logits_finite": bool(finite),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "params": params, "cache": cache}


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        ap.exit(1, f"{ap.prog}: {exc}\n")

    if args.shard_server:
        # RPC-server role: no LM
        from repro_torch.net.shard_server import run

        run(args.shard_server, host=args.host, port=args.port,
            read_only=args.read_only, metrics_port=args.metrics_port,
            device=args.device)
        return

    if args.metrics_port is not None:
        # LM path: expose the store/client/kernel metrics this process
        # records while it serves (scrape http://host:port/metrics)
        from repro_torch.obs import start_metrics_server

        metrics = start_metrics_server(port=args.metrics_port)
        print(f"metrics: http://127.0.0.1:{metrics.port}/metrics", flush=True)
    serve_lm(args, dev)


if __name__ == "__main__":
    main()
