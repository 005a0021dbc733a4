"""The controls of the check that decides ``correct``, and sound runs beside
them, on many seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--control code|unchecked] [--device cuda]

Each seed is one run of the cell (:func:`harness.run_cell`) with a short
window; the line it prints holds every number compared and its limit.
Without ``--control`` the port runs as the benchmark runs it (the lower
readings).  With ``--control`` a guarantee of the configuration is broken
in the port's place (the upper readings).  ``code``:

* a compress writes the optimal code limited to one bit less than the
  exact tree's longest code (the port's own ``max_code_len`` path): a
  valid container, a little larger, that is not the reference's;
* a decompress decodes with a one-level table one bit narrower than the
  longest code and no escape (the plain reference decoder, narrowed): the
  bytes that hold a longest code come out wrong.

``unchecked``: the port decompresses with its CRC check off
(``check=False``), so a corrupt container is decoded, not refused.

The benchmark's own runs never run a control.
"""

from __future__ import annotations

import json
import os
import sys
import time

T_START = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import numpy as np  # noqa: E402

import harness  # noqa: E402
import reference  # noqa: E402


def _read(path: str) -> np.ndarray:
    with open(path, "rb") as fp:
        return np.frombuffer(fp.read(), dtype=np.uint8)


class Unchecked(harness.Port):
    """The port with its CRC check off, as the module says."""

    def __init__(self, config: dict, device: str):
        super().__init__(config, device)
        self.dkw["check"] = False


class Control(harness.Port):
    """The port with one guarantee broken, as the module says."""

    def __init__(self, config: dict, device: str):
        super().__init__(config, device)
        self._longest: dict = {}

    def compress(self, src: str, dst: str) -> None:
        if src not in self._longest:
            counts = reference.byte_counts(_read(src), self.device)
            self._longest[src] = reference.huff_code(counts).max_len
        self._c(src, dst, device=self.device,
                max_code_len=self._longest[src] - 1, **self.ckw)

    def decompress(self, src: str, dst: str) -> None:
        buf = _read(src)
        longest = int(reference.parse_header(buf).lengths.max())
        out = reference.decode(buf, device=self.device, max_bits=longest - 1)
        with open(dst, "wb") as fp:
            fp.write(out.tobytes())


CONTROLS = {"code": Control, "unchecked": Unchecked}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        system = CONTROLS.get(args.control, harness.Port)(cell.config,
                                                          args.device)
        run = harness.run_cell(cell, seed, args.seconds, False, args.device,
                               system=system, log=lambda *a: None)
        line = {"seed": seed, "control": args.control,
                "correct": harness.correct(run), "calls": len(run.calls),
                "checks": {k: v for k, (v, _) in run.checks.items()}}
        readings.append(line)
        print(json.dumps(line), flush=True)
    worst = {k: max(r["checks"][k] for r in readings)
             for k in readings[0]["checks"]}
    least = {k: min(r["checks"][k] for r in readings)
             for k in readings[0]["checks"]}
    print(json.dumps({"workload": cell.name, "control": args.control,
                      "seeds": len(readings), "largest": worst,
                      "smallest": least,
                      "all_correct": all(r["correct"] for r in readings)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
