"""Time render() on one GPU under several configurations of one bench config.

    python tools/probe.py --config 1 --spp 4 --reps 5 \\
        --case backend=xla --case backend=xla,tile_size=2073600 \\
        --case pallas_lanes=128

Each --case is a comma-separated list of RenderConfig overrides applied to
bench.py's config (values parsed as Python literals). Cases run one after
another, each in its own child process (one JAX process on the card at a
time; a case whose kernel fails to compile fails alone). A case warms up
with one render() call (compile included), then times --reps calls of
--spp samples each, every call ending in block_until_ready.

Prints the card's `nvidia-smi` name and power limit, then one JSON line per
case: overrides, compile_s, segments per call, segments/s of every timed
call and their median and quartiles, or the child's exit code and the end
of its error output.
"""
import argparse
import ast
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_case(text: str) -> dict:
    """"k=v,k=v" -> {k: literal}. Parsed without importing tpurt: the
    parent must stay off JAX, whose first array would reserve the card's
    memory that the child needs (the child validates the field names)."""
    out = {}
    for kv in filter(None, text.split(",")):
        k, _, v = kv.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v  # bare strings (backend=xla)
    return out


def child(config_id: int, small: bool, spp: int, reps: int,
          overrides: dict) -> dict:
    sys.path.insert(0, ROOT)
    import jax
    import numpy as np
    from bench import build_bench
    from tpurt import init_state, render
    from tpurt.runtime import device_fields, enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()
    from tpurt.config import RenderConfig
    cfg, scene, cam = build_bench(config_id, small)
    cfg = cfg.with_(**RenderConfig.parse_overrides(
        [f"{k}={v!r}" for k, v in overrides.items()]))
    state = init_state(cfg)
    t0 = time.perf_counter()
    state = jax.block_until_ready(render(scene, cfg, cam, state, 1234, spp))
    compile_s = time.perf_counter() - t0
    rates, segs = [], []
    for _ in range(reps):
        r0 = float(state.rays)
        t0 = time.perf_counter()
        state = jax.block_until_ready(
            render(scene, cfg, cam, state, 1234, spp))
        dt = time.perf_counter() - t0
        segs.append(float(state.rays) - r0)
        rates.append(segs[-1] / dt)
    q1, med, q3 = np.percentile(rates, [25, 50, 75])
    return {"config": config_id, "overrides": overrides, "spp": spp,
            **device_fields(), "compile_s": compile_s,
            "segments_per_call": segs, "segments_per_s": rates,
            "median": med, "q1": q1, "q3": q3}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=int, default=1)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--case", action="append", default=[],
                    help="comma-separated RenderConfig overrides")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds allowed per case")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.child is not None:
        print(json.dumps(child(args.config, args.small, args.spp, args.reps,
                               json.loads(args.child))), flush=True)
        return
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    except FileNotFoundError:
        print("nvidia-smi: not found", flush=True)
    for case in args.case or [""]:
        ov = parse_case(case)
        cmd = [sys.executable, os.path.abspath(__file__),
               "--config", str(args.config), "--spp", str(args.spp),
               "--reps", str(args.reps), "--child", json.dumps(ov)]
        if args.small:
            cmd.append("--small")
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
        except subprocess.TimeoutExpired:
            print(json.dumps({"overrides": ov, "error": "timeout"}),
                  flush=True)
            continue
        lines = p.stdout.strip().splitlines()
        if p.returncode == 0 and lines:
            print(lines[-1], flush=True)
        else:
            print(json.dumps({"overrides": ov, "rc": p.returncode,
                              "stderr": p.stderr[-600:]}), flush=True)


if __name__ == "__main__":
    main()
