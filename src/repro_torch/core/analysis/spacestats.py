"""Table VIII: search-space cardinality accounting.

Columns mirror the paper: Cardinality (raw cross product), Constrained
(structural constraints), Valid (runs on a given architecture — here: a
finite measured time on that device), Reduced (PFI ≥ 0.05 params only),
Reduce-Constrained.

``space_stats`` evaluates every constrained config through
``problem.exhaustive``; on a measured problem that times the whole space,
so a caller that has measured it already passes a problem that looks the
trials up (``repro_torch.landscape`` does).
"""

from __future__ import annotations


from ..problem import DEFAULT_ARCH, TunableProblem
from ..space import SearchSpace


def space_stats(problem: TunableProblem,
                archs: tuple[str, ...] = (DEFAULT_ARCH,),
                exhaustive_limit: int = 300_000,
                sample_n: int = 4000) -> dict:
    """Cardinality accounting, exact wherever the compiled table reaches.

    'Constrained' comes straight from the compiled valid-row mask whenever
    the cross product fits the compile limit (so spaces the sampling
    estimator previously approximated are now exact); the per-arch 'Valid'
    column needs a cost-model evaluation per constrained config and stays
    exhaustive only under ``exhaustive_limit``.
    """
    sp = problem.space
    card = sp.cardinality
    out = {"problem": problem.name, "cardinality": card}

    comp = sp.compiled()
    if comp is not None:
        out["constrained"] = comp.n_valid
    elif card <= exhaustive_limit:
        out["constrained"] = sp.constrained_cardinality()
    else:
        # estimate the constrained fraction by sampling the raw cross product
        import random
        rng = random.Random(0)
        hits = 0
        for _ in range(sample_n):
            cfg = {p.name: rng.choice(p.values) for p in sp.params}
            if sp.satisfies(cfg):
                hits += 1
        out["constrained"] = int(card * hits / sample_n)

    exact_constrained = comp is not None or card <= exhaustive_limit
    valid = {}
    if exact_constrained and out["constrained"] <= exhaustive_limit:
        for a in archs:
            valid[a] = sum(1 for t in problem.exhaustive(a) if t.ok)
        out["exact"] = True
    else:
        for a in archs:
            trials = problem.sampled(min(sample_n, 2000), 0, a)
            frac = sum(t.ok for t in trials) / max(1, len(trials))
            valid[a] = int(out["constrained"] * frac)
        out["exact"] = False
    out["valid"] = valid
    return out


def reduced_stats(space: SearchSpace, reduced: SearchSpace,
                  exhaustive_limit: int = 300_000) -> dict:
    out = {"reduced": reduced.cardinality}
    if reduced.compiled() is not None \
            or reduced.cardinality <= exhaustive_limit:
        out["reduce_constrained"] = reduced.constrained_cardinality()
    else:
        import random
        rng = random.Random(0)
        hits = sum(
            1 for _ in range(2000)
            if reduced.satisfies({p.name: rng.choice(p.values)
                                  for p in reduced.params}))
        out["reduce_constrained"] = int(reduced.cardinality * hits / 2000)
    return out
