#!/usr/bin/env python3
"""Run the ``torchrun`` jobs of ``tests/test_torch_distributed.py`` many
times, several jobs at once, and count the jobs in which a rank died: the
check that a test worker's teardown is sound under load.

    PYTHONPATH=src python3 scripts/torchrun_teardown_stress.py OUT \
        [--tests DIR] [--rounds 60] [--parallel 6] [--world 4]

Each round is one ``torchrun --nproc-per-node W`` job of three fresh
trainings (AdamW with the clip, adafactor, AdamW through a halving
rung), through the harness of ``DIR/test_torch_distributed.py`` (its
worker script and its ``torchrun``; ``--tests`` may point at another
checkout's tests, e.g. the parent commit's, with ``PYTHONPATH`` at that
checkout's ``src``).  ``--world 4`` is the population axis alone (a mesh
of (1, 4)); 3 and 6 have a data axis ((3, 1), (3, 2): the data column a
group of its own, the world at W = 3), as the jobs of
``tests/test_torch_data_axis.py``.  Prints each round's exit code, each
failed round's rank stderr (from the harness's ``--log-dir`` where it
keeps one), and the count of failed rounds.
"""
import argparse
import concurrent.futures as cf
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", type=Path)
    ap.add_argument("--tests", type=Path,
                    default=Path(__file__).resolve().parents[1] / "tests")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--parallel", type=int, default=6)
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tests))
    import test_torch_distributed as t

    halving = t.OPT["adamw"] + ["--steps", "6", "--halving", "2:0.5"]

    def one(i):
        d = args.out / f"r{i}"
        d.mkdir(parents=True, exist_ok=True)
        r = t.torchrun(d, args.world, [
            t._train(d, "adamw", t.OPT["adamw"] + ["--steps", "4"]),
            t._train(d, "adafactor", t.OPT["adafactor"] + ["--steps", "4"]),
            t._train(d, "halving", halving)])
        text = ""
        if r.returncode:
            logs = getattr(r, "logs", None)
            if logs is not None:
                text = "".join(f"--- rank {p.parent.name}\n{p.read_text()}"
                               for p in sorted(logs.rglob("stderr.log")))
            else:
                text = r.stderr[-4000:]
        return i, r.returncode, text

    failed = 0
    with cf.ThreadPoolExecutor(args.parallel) as ex:
        for i, rc, text in ex.map(one, range(args.rounds)):
            print(f"round {i}: exit {rc}", flush=True)
            if rc:
                failed += 1
                print(text, flush=True)
    print(f"{failed} of {args.rounds} rounds failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
