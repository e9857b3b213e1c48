"""Command line of the port: the ``--serve`` subset of the JAX package's
``cli/main.py``, same flag names and defaults, same synthetic trace and
summary line.

    python -m pytorch_distributed_training_tpu_torch.cli.main --serve \\
        --model gpt2 --precision bf16 --serve-slots 8 --serve-requests 16

runs on CUDA; add ``--use-cpu`` to run on the host, and ``--serve-paged
[--serve-kv-dtype int8] [--serve-kv-host-mb 64]`` for the paged KV pool.
Training and checkpoint restore are not ported yet, so the server runs
fresh-init weights drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _parse_overrides(text: str | None) -> dict:
    """``"num_layers=2,hidden_dim=64"`` → dict of int/float/bool values."""
    overrides: dict = {}
    for item in (text or "").split(","):
        if not item.strip():
            continue  # tolerate trailing commas
        k, sep, v = item.partition("=")
        k, v = k.strip(), v.strip()
        if not sep or not k or not v:
            raise ValueError(f"--model-overrides entry {item!r} is not key=value")
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
            continue
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                raise ValueError(
                    f"--model-overrides value for {k!r} must be "
                    f"int/float/bool, got {v!r}"
                ) from None
    return overrides


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pytorch_distributed_training_tpu_torch.cli.main",
        description="Continuous-batching GPT-2 serving on CUDA (PyTorch port).",
    )
    p.add_argument("--use-cpu", action="store_true",
                   help="Run on the host instead of the CUDA device.")
    p.add_argument("--model", default="gpt2", help="gpt2|gpt2_medium|...")
    p.add_argument("--model-overrides", default=None,
                   help="Comma-separated config overrides, e.g. "
                        "'num_layers=2,hidden_dim=64,vocab_size=512'.")
    p.add_argument("--precision", default="f32", help="f32|bf16|bf16_full")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=1024,
                   help="LM sequence length (bounds the synthetic prompts).")
    p.add_argument("--metrics-jsonl", default=None,
                   help="Append one record per finished request here.")
    p.add_argument("--serve", action="store_true",
                   help="Serve the model on a synthetic mixed-length "
                        "request trace (the only mode ported so far).")
    p.add_argument("--serve-requests", type=int, default=16)
    p.add_argument("--serve-rate", type=float, default=0.0,
                   help="Offered load in requests/sec, Poisson arrivals "
                        "(0 = all requests arrive at t=0).")
    p.add_argument("--serve-slots", type=int, default=4,
                   help="Concurrent decode slots (KV-cache pool rows).")
    p.add_argument("--serve-max-new", type=int, default=32,
                   help="Per-request generation budget cap.")
    p.add_argument("--serve-prefill-chunk", type=int, default=16,
                   help="Prompt tokens written per prefill tick.")
    p.add_argument("--serve-paged", action="store_true",
                   help="Paged KV cache: fixed-size blocks and per-slot "
                        "block tables instead of contiguous rows; shared "
                        "prompt prefixes skip prefill via the block cache.")
    p.add_argument("--serve-block-size", type=int, default=16,
                   help="KV positions per block (--serve-paged); also the "
                        "prefix-cache sharing granularity.")
    p.add_argument("--serve-num-blocks", type=int, default=0,
                   help="Blocks in the pool (--serve-paged); 0 sizes it "
                        "like the contiguous pool (slots x ceil(max_len / "
                        "block_size)).")
    p.add_argument("--serve-kv-dtype", default="bf16",
                   choices=("bf16", "int8", "int4"),
                   help="KV storage (--serve-paged): bf16 keeps the model's "
                        "dtype; int8/int4 quantize the blocks with a bf16 "
                        "scale per position and head.")
    p.add_argument("--serve-kv-host-mb", type=float, default=0.0,
                   help="Host-RAM KV tier in MB (--serve-paged): evicted "
                        "prefix blocks spill there and are restored on a "
                        "hit; 0 = no host tier.")
    p.add_argument("--serve-spec", action="store_true",
                   help="Speculative decoding with the prompt-lookup drafter.")
    p.add_argument("--serve-spec-k", type=int, default=4,
                   help="Max draft tokens verified per slot per tick.")
    p.add_argument("--serve-spec-ngram", type=int, default=4,
                   help="Longest suffix n-gram the drafter matches.")
    return p


def run_serve(*, model, overrides, precision, seed, seq_len, metrics_jsonl,
              n_requests, rate, num_slots, max_new, prefill_chunk, spec_k=0,
              spec_ngram=4, device=None, paged=False, block_size=16,
              num_blocks=0, kv_dtype="bf16", kv_host_mb=0.0) -> dict:
    """Serve ``model`` over the synthetic trace and print the summary.

    Returns ``{"summary", "engine", "tokens"}``: the SLO summary, the
    engine's counters, and every request's generated tokens by id."""
    from ..models import create_model
    from ..serve import (
        ContinuousScheduler, Request, ServingEngine, summarize_records,
    )
    from ..train import make_policy
    from ..utils import metrics as metrics_lib
    from ..utils.device import resolve_device

    if kv_host_mb and not paged:
        raise SystemExit(
            "--serve-kv-host-mb spills paged blocks — add --serve-paged"
        )
    if kv_dtype != "bf16" and not paged:
        raise SystemExit(
            "--serve-kv-dtype quantizes paged blocks — add --serve-paged"
        )
    device = resolve_device(device)
    policy = make_policy(precision)
    # Serving casts every parameter (LayerNorm and embeddings included) to
    # the compute dtype, as the JAX CLI does.
    print("warning: serving FRESH-INIT weights (pass --checkpoint-dir "
          "with a trained run for real outputs)")
    net = create_model(
        model, dtype=policy.compute_dtype, device=device, seed=seed,
        cfg_overrides=overrides,
    )
    if max_new > net.cfg.max_seq_len - 2:
        raise ValueError(
            f"--serve-max-new {max_new} leaves no room for a prompt in the "
            f"model's {net.cfg.max_seq_len}-position cache"
        )
    max_len = net.cfg.max_seq_len
    tokens: dict = {}
    engine = ServingEngine(
        net, num_slots=num_slots, max_len=max_len,
        prefill_chunk=prefill_chunk, temperature=0.0, seed=seed,
        spec_k=spec_k, spec_ngram=spec_ngram, device=device,
        stream_cb=lambda rid, tok: tokens.setdefault(rid, []).append(tok),
        paged=paged, block_size=block_size, num_blocks=num_blocks or None,
        kv_dtype=kv_dtype, kv_host_mb=kv_host_mb or None,
    )
    rng = np.random.default_rng(seed)
    p_hi = max(min(seq_len, max_len - max_new) // 2, 2)
    prompts = [
        rng.integers(0, net.cfg.vocab_size,
                     (int(rng.integers(2, p_hi + 1)),)).astype(np.int32)
        for _ in range(n_requests)
    ]
    budgets = rng.integers(max(max_new // 4, 1), max_new + 1, n_requests)
    if rate and rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    else:
        arrivals = np.zeros(n_requests)
    t0 = time.monotonic()
    requests = [
        Request(i, prompts[i], int(budgets[i]), float(t0 + arrivals[i]))
        for i in range(n_requests)
    ]
    req_log = (
        metrics_lib.RequestLogger(metrics_jsonl) if metrics_jsonl else None
    )
    # The whole trace is this tool's own workload: queue all of it.
    scheduler = ContinuousScheduler(
        engine, max_queue=n_requests, request_logger=req_log,
    )
    layout = (
        f"paged ({engine.pool.num_blocks} blocks x {block_size})" if paged
        else "contiguous"
    )
    if kv_dtype != "bf16":
        layout += f", kv={kv_dtype}"
    if kv_host_mb:
        layout += f" + {kv_host_mb:g} MB host KV tier"
    spec_note = f", spec k={spec_k} ngram={spec_ngram}" if spec_k else ""
    print(
        f"serving started: {n_requests} requests, {num_slots} slots "
        f"({layout}), rate={rate or 'burst'} req/s, "
        f"prefill_chunk={prefill_chunk}{spec_note}"
    )
    # Every tick reads its sampled tokens back to the host, so the trace
    # has finished on the device when run() returns.
    records = scheduler.run(requests)
    elapsed = time.monotonic() - t0
    summary = summarize_records(
        records, elapsed=elapsed,
        queue_depth_samples=scheduler.queue_depth_samples,
        rejected=scheduler.rejected,
        active_slot_samples=scheduler.active_slot_samples,
        engine_stats=engine.stats() if (paged or spec_k) else None,
    )
    if spec_k and summary.get("spec"):
        sp = summary["spec"]
        print(
            f"speculation: acceptance_rate={sp['acceptance_rate']} "
            f"({sp['accepted_tokens']}/{sp['drafted_tokens']} drafted), "
            f"tokens_per_tick={sp['tokens_per_decode_tick']}"
        )
    if paged:
        st = engine.stats()
        hit_rate = (
            st["prefix_hit_tokens"] / st["prefix_lookup_tokens"]
            if st["prefix_lookup_tokens"] else 0.0
        )
        print(
            f"paged pool: prefix_hit_rate={hit_rate:.3f} "
            f"blocks_evicted={st['blocks_evicted']} "
            f"prefill_tokens={st['prefill_tokens_computed']}/"
            f"{st['prefill_tokens_offered']}"
        )
        if kv_host_mb:
            print(
                f"host KV tier: spilled={st.get('blocks_spilled', 0)} "
                f"restored={st.get('blocks_restored', 0)} "
                f"dropped={st.get('host_dropped_blocks', 0)} "
                f"resident={st.get('host_blocks', 0)} blocks"
            )
    metrics_lib.MetricsLogger(None).log({"mode": "serve", **{
        k: v for k, v in summary.items() if not isinstance(v, dict)
    }})
    return {"summary": summary, "engine": engine.stats(), "tokens": tokens}


def main(argv: list[str] | None = None):
    args = build_parser().parse_args(argv)
    if not args.serve:
        raise SystemExit(
            "only --serve is ported so far (training is a later slice)"
        )
    from ..models import model_kind

    if model_kind(args.model) != "lm":
        raise SystemExit("--serve requires a transformer LM (--model gpt2*)")
    try:
        overrides = _parse_overrides(args.model_overrides)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return run_serve(
        model=args.model, overrides=overrides, precision=args.precision,
        seed=args.seed, seq_len=args.seq_len,
        metrics_jsonl=args.metrics_jsonl, n_requests=args.serve_requests,
        rate=args.serve_rate, num_slots=args.serve_slots,
        max_new=args.serve_max_new, prefill_chunk=args.serve_prefill_chunk,
        spec_k=args.serve_spec_k if args.serve_spec else 0,
        spec_ngram=args.serve_spec_ngram,
        device="cpu" if args.use_cpu else None,
        paged=args.serve_paged, block_size=args.serve_block_size,
        num_blocks=args.serve_num_blocks, kv_dtype=args.serve_kv_dtype,
        kv_host_mb=args.serve_kv_host_mb,
    )


if __name__ == "__main__":
    main(sys.argv[1:])
