"""The SLO stage vocabulary of the metric catalog.

A copy of the provenance stage list of
``kubeadmiral_tpu/runtime/metric_catalog.py``, which ``runtime/slo.py``
reads.  The rest of the JAX catalog (the declared SLO objectives the
burn-rate evaluator runs, the metric families that
``tools/metrics_lint.py`` checks emissions against, the event and
decision vocabularies) is not copied: the port has no evaluator yet, and
its control plane is checked against the JAX one by its tests.
"""

from __future__ import annotations

# Provenance stage vocabulary, in pipeline order (runtime/slo.py STAGES).
SLO_STAGES: tuple[str, ...] = (
    "queued", "slab", "engine", "fetch", "dispatch", "write",
)
