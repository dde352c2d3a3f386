"""Run the full test suite and write TESTS.json — committed run evidence
("an unevidenced suite is half a suite", SURVEY.md §4).

Tiers (tests/conftest.py): the fast tier runs as one pytest process; the
slow tier runs ONE MODULE PER PROCESS — the conftest's own guidance (a
flaky XLA:CPU compiler segfault has hit hour-long single-process runs, and
per-module processes isolate any crash to one module's report).

TESTS.json records, per module: pass/fail counts, duration, and the exit
status; plus the fast-tier summary and the grand total. Regenerate after
the last kernel change (like QUALITY.json).

Usage:
  python tools/run_tests.py              # fast + slow (the full suite)
  python tools/run_tests.py --fast-only  # fast tier only (quick check)
  python tools/run_tests.py --modules test_golden test_mega_pallas
"""
import argparse
import datetime
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def slow_modules():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    # parse rather than import: importing conftest would initialize jax here
    text = open(os.path.join(ROOT, "tests", "conftest.py")).read()
    block = re.search(r"SLOW_MODULES = \{(.*?)\}", text, re.S).group(1)
    return sorted(re.findall(r'"(test_\w+)"', block))


def parse_counts(output: str):
    """(passed, failed, skipped) from a pytest summary line."""
    counts = {"passed": 0, "failed": 0, "skipped": 0, "error": 0}
    for n, kind in re.findall(r"(\d+) (passed|failed|skipped|error)s?",
                              output):
        counts[kind] = int(n)
    return counts


def run_pytest(args_list, timeout=3600):
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", *args_list],
            cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        out = proc.stdout + proc.stderr
        rc = proc.returncode
    except subprocess.TimeoutExpired as e:
        out = (e.stdout or "") + (e.stderr or "") + "\nTIMEOUT"
        rc = -1
    dt = time.time() - t0
    counts = parse_counts(out)
    return {"rc": rc, "duration_s": round(dt, 1), **counts,
            "tail": out.strip().splitlines()[-1] if out.strip() else ""}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast-only", action="store_true")
    ap.add_argument("--modules", nargs="*",
                    help="run only these slow modules (still per-process)")
    ap.add_argument("--merge", action="store_true",
                    help="update the existing TESTS.json with this run's "
                         "module results instead of starting fresh (for "
                         "modules added after a full run)")
    ap.add_argument("--out", default=os.path.join(ROOT, "TESTS.json"))
    args = ap.parse_args()

    report = {
        "generated": datetime.datetime.now().isoformat(timespec="seconds"),
        "command": "python tools/run_tests.py "
        + " ".join(sys.argv[1:]) if len(sys.argv) > 1
        else "python tools/run_tests.py",
        "modules": {},
    }
    if args.merge and os.path.exists(args.out):
        prev = json.load(open(args.out))
        report["modules"] = prev.get("modules", {})
        if "fast_tier" in prev:
            report["fast_tier"] = prev["fast_tier"]

    if not args.modules:
        print("== fast tier (one process) ==", flush=True)
        fast = run_pytest(["tests/", "-m", "not slow", "-x"])
        report["fast_tier"] = fast
        print(f"   {fast['passed']} passed, {fast['failed']} failed "
              f"in {fast['duration_s']}s", flush=True)

    if not args.fast_only:
        mods = args.modules or slow_modules()
        for mod in mods:
            print(f"== slow: {mod} ==", flush=True)
            res = run_pytest([f"tests/{mod}.py"])
            report["modules"][mod] = res
            print(f"   {res['passed']} passed, {res['failed']} failed, "
                  f"{res['skipped']} skipped in {res['duration_s']}s"
                  + ("" if res["rc"] == 0 else f"  [rc={res['rc']}]"),
                  flush=True)

    mods = report["modules"].values()
    report["total"] = {
        "passed": sum(m["passed"] for m in mods)
        + report.get("fast_tier", {}).get("passed", 0),
        "failed": sum(m["failed"] for m in mods)
        + report.get("fast_tier", {}).get("failed", 0),
        "skipped": sum(m["skipped"] for m in mods)
        + report.get("fast_tier", {}).get("skipped", 0),
        "duration_s": round(sum(m["duration_s"] for m in mods)
                            + report.get("fast_tier",
                                         {}).get("duration_s", 0), 1),
        "all_green": all(m["rc"] == 0 for m in mods)
        and report.get("fast_tier", {"rc": 0})["rc"] == 0,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    t = report["total"]
    print(f"\nTOTAL: {t['passed']} passed, {t['failed']} failed, "
          f"{t['skipped']} skipped in {t['duration_s']}s "
          f"-> {args.out}  all_green={t['all_green']}")
    return 0 if t["all_green"] else 1


if __name__ == "__main__":
    sys.exit(main())
