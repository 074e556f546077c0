"""Runner of the port's paper benchmarks (counterpart of
``benchmarks/run.py``): ``python -m benchmarks.torch_port.run [names...]``.

Runs every table and figure of ``paper_benches.ALL`` (or the names given)
at its default sizes on ``--device`` (default: the card), prints each as a
CSV block and writes experiments/bench/torch/<name>.json: the rows and the
device they ran on.  A benchmark that fails is reported and the rest still
run; the exit code is then 1.
"""

from __future__ import annotations

import argparse
import sys
import time

from benchmarks.torch_port import common


def main(argv=None) -> int:
    from benchmarks.torch_port.paper_benches import ALL, _rows_to_csv

    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", help=f"default: all of {list(ALL)}")
    common.add_device_arg(ap)
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    unknown = sorted(set(args.names) - set(ALL))
    if unknown:
        ap.error(f"unknown benchmarks {unknown}; choose from {list(ALL)}")
    dev = common.device_of(args)
    device = common.device_record(dev)
    failures = 0
    for name in args.names or list(ALL):
        t0 = time.time()
        print(f"== {name} ==", flush=True)
        try:
            rows = ALL[name](device=dev)
            print(_rows_to_csv(rows))
            common.write_json({"device": device, "name": name, "rows": rows},
                              common.out_path(f"{name}.json"))
            print(f"-- {name}: {len(rows)} rows in {time.time() - t0:.1f}s\n", flush=True)
        except Exception as e:  # keep going; report at the end
            import traceback

            failures += 1
            print(f"-- {name} FAILED: {type(e).__name__}: {e}")
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
