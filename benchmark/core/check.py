"""The comparison that decides ``correct``: one pair's result table from
the timed path against the plain reference's on the same frames.

Numbers, each held to the limit its configuration file gives:

* ``seed_mismatch``: POIs the refiner ran whose FFTCC seed (the table's
  u0, v0(, w0)) differs from the reference's integer peak;
* ``code_mismatch``: POIs whose outcome differs (a failure code, or
  success), but for ties of the -3 rule: a POI failed with -3 on one side
  only, whose reference read a sample within ``TIE_GREY`` of zero (a
  negative sample fails a POI, so the sign of a sample that close to zero
  is a matter of rounding);
* ``disp_gap``: the largest |displacement - reference| over POIs both
  sides refined successfully (pixels or voxels);
* ``disp_gap_mean``: its mean over those POIs;
* ``grad_gap``: the largest gap of a displacement gradient there;
* ``zncc_gap``: the largest ZNCC gap there;
* ``strain_gap``: the largest gap of a strain component, over all POIs
  but those ties (a POI only one side gives strain reads its whole
  value).

A pipeline states where its table keeps each quantity (``Layout``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np

# grey levels: a reference sample this close to zero may take the other
# sign in the program's float32, so a -3 on one side there is a tie
TIE_GREY = 0.01


@dataclasses.dataclass(frozen=True)
class Layout:
    """Columns of the program's table: ``seed`` in ``r`` (u0, v0(, w0)),
    ``zncc`` and ``iterations`` in ``r``, ``disp`` and ``grad`` in ``p``;
    ``ref_disp`` and ``ref_grad`` the same quantities in the reference's
    ``p``."""

    seed: Sequence[int]
    zncc: int
    iterations: int
    disp: Sequence[int]
    grad: Sequence[int]
    ref_disp: Sequence[int]
    ref_grad: Sequence[int]


def _max(a: np.ndarray) -> float:
    return float(np.max(a)) if a.size else float("inf")


def compare(layout: Layout, out: Dict[str, np.ndarray],
            ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    p = out["p"].astype(np.float64)
    r = out["r"].astype(np.float64)
    code = r[:, layout.zncc]
    ref_code = ref["zncc"]
    ran = r[:, layout.iterations] >= 1
    seed = r[:, list(layout.seed)]
    seed_bad = ran & (seed != ref["seed"]).any(1)
    cls = np.where(code >= 0, 1.0, code)
    ref_cls = np.where(ref_code >= 0, 1.0, ref_code)
    tie = (((cls == -3) != (ref_cls == -3))
           & (ref["closest"] < TIE_GREY))
    both = (code >= 0) & (ref_code >= 0)
    disp = np.abs(p[both][:, list(layout.disp)]
                  - ref["p"][both][:, list(layout.ref_disp)])
    grad = np.abs(p[both][:, list(layout.grad)]
                  - ref["p"][both][:, list(layout.ref_grad)])
    return {
        "seed_mismatch": float(seed_bad.sum()),
        "code_mismatch": float(((cls != ref_cls) & ~tie).sum()),
        "disp_gap": _max(disp),
        "disp_gap_mean": float(disp.mean()) if disp.size else float("inf"),
        "grad_gap": _max(grad),
        "zncc_gap": _max(np.abs(code[both] - ref_code[both])),
        "strain_gap": _max(np.abs(out["e"].astype(np.float64)
                                  - ref["strain"])[~tie]),
    }


def worst(readings) -> Dict[str, float]:
    """The worst of each number over several pairs' readings."""
    readings = list(readings)
    return {k: max(r[k] for r in readings) for k in readings[0]}


def drawn(seed: int, ran: Iterable[int], n: int) -> List[int]:
    """The targets a run with ``seed`` compares: ``n`` of the target
    indices ``ran``, drawn from the seed."""
    pick = np.random.default_rng(seed).permutation(sorted(ran))[:n]
    return sorted(pick.tolist())


def judge(pipe, cfg: dict, seq, outputs: Callable[[int], list],
          ran: Iterable[int], seed: int, device):
    """Every output of each drawn target (``outputs(k)``: the host tables
    of target ``k``) against the plain reference of its pair.  Returns
    (the drawn targets, one reading a table, the reference's seconds)."""
    chosen = drawn(seed, ran, int(cfg["check"]["targets"]))
    readings, ref_s = [], 0.0
    for k in chosen:
        t0 = time.perf_counter()
        ref = pipe.reference(cfg, seq.reference, seq.targets[k], device)
        ref_s += time.perf_counter() - t0
        readings.extend(compare(pipe.LAYOUT, out, ref)
                        for out in outputs(k))
    return chosen, readings, ref_s


def verdict(readings, limits: Dict[str, float]):
    """(each number's worst reading beside its limit, the tables that break
    a limit, whether the run is correct: some reading, none over)."""
    readings = list(readings)
    if not readings:
        return {}, 0, False
    top = worst(readings)
    checks = {name: (top[name], float(lim)) for name, lim in limits.items()}
    failed = sum(any(r[n] > lim for n, lim in limits.items())
                 for r in readings)
    return checks, failed, all(v <= lim for v, lim in checks.values())
