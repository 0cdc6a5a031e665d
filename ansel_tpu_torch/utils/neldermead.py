"""Nelder-Mead downhill-simplex minimizer.

Reference: `ansel/src/math/nelder_mead_simplex.h` (Hutt's
nmsimplex with darktable's interface changes) — same coefficients
(alpha=1, beta=0.5, gamma=2), same right-simplex initialisation
(pn/qn from Spendley's construction), same convergence test (stddev of
vertex values over n < epsilon), and the same contract: `simplex()`
returns the iteration count so callers detect non-convergence by
`iters >= maxiter`, with the best vertex written back into `start`.

A copy of `ansel_tpu/utils/neldermead.py` (pure Python, no JAX).
Consumer: ashift's automatic fit (`ops/ashift_fit.py`, reference
`iop/ashift.c:2284`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

NMS_ALPHA = 1.0
NMS_BETA = 0.5
NMS_GAMMA = 2.0


def simplex(objfunc: Callable[[Sequence[float]], float],
            start: List[float], n: int, epsilon: float, scale: float,
            maxiter: int,
            constrain: Optional[Callable[[List[float]], None]] = None
            ) -> int:
    """Minimize objfunc over n params; start is updated in place with the
    best vertex.  Returns the number of iterations used."""
    # right-simplex construction (nelder_mead_simplex.h:145-166)
    pn = scale * (math.sqrt(n + 1) - 1 + n) / (n * math.sqrt(2))
    qn = scale * (math.sqrt(n + 1) - 1) / (n * math.sqrt(2))

    v = [list(start)]
    for i in range(1, n + 1):
        v.append([pn + start[j] if (i - 1) == j else qn + start[j]
                  for j in range(n)])
    if constrain is not None:
        for vi in v:
            constrain(vi)
    f = [objfunc(vi) for vi in v]

    itr = 0
    for itr in range(1, maxiter + 1):
        # order: vg = worst, vs = best, vh = second-worst
        vg = max(range(n + 1), key=lambda j: f[j])
        vs = min(range(n + 1), key=lambda j: f[j])
        vh = max((j for j in range(n + 1) if j != vg),
                 key=lambda j: f[j])

        # centroid excluding the worst vertex
        vm = [sum(v[j][i] for j in range(n + 1) if j != vg) / n
              for i in range(n)]

        # reflection
        vr = [vm[i] + NMS_ALPHA * (vm[i] - v[vg][i]) for i in range(n)]
        if constrain is not None:
            constrain(vr)
        fr = objfunc(vr)

        if f[vs] <= fr < f[vh]:
            v[vg], f[vg] = vr, fr
        elif fr < f[vs]:
            # expansion
            ve = [vm[i] + NMS_GAMMA * (vr[i] - vm[i]) for i in range(n)]
            if constrain is not None:
                constrain(ve)
            fe = objfunc(ve)
            if fe < fr:
                v[vg], f[vg] = ve, fe
            else:
                v[vg], f[vg] = vr, fr
        else:  # fr >= f[vh] -> contraction
            if fr < f[vg]:
                vc = [vm[i] + NMS_BETA * (vr[i] - vm[i])
                      for i in range(n)]
            else:
                vc = [vm[i] - NMS_BETA * (vm[i] - v[vg][i])
                      for i in range(n)]
            if constrain is not None:
                constrain(vc)
            fc = objfunc(vc)
            if fc < f[vg]:
                v[vg], f[vg] = vc, fc
            else:
                # shrink toward the best vertex
                for row in range(n + 1):
                    if row == vs:
                        continue
                    v[row] = [v[vs][i] + (v[row][i] - v[vs][i]) / 2.0
                              for i in range(n)]
                if constrain is not None:
                    constrain(v[vg])
                    constrain(v[vh])
                f[vg] = objfunc(v[vg])
                f[vh] = objfunc(v[vh])

        # convergence: stddev of the vertex values (over n, as reference)
        favg = sum(f) / (n + 1)
        s = math.sqrt(sum((fj - favg) ** 2 for fj in f) / n)
        if s < epsilon:
            break

    vs = min(range(n + 1), key=lambda j: f[j])
    start[:] = v[vs]
    return itr
