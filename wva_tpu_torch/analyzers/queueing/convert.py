"""Carry solver state across from plain numpy data.

The tests feed the JAX package and the port the same candidates and the
same profiles; these helpers build the port's side from plain values (the
JAX ``CandidateBatch`` fields as numpy arrays, profiles as records).
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping

import numpy as np

from wva_tpu_torch.analyzers.queueing.params import (
    PerfProfile,
    PerfProfileStore,
    ServiceParms,
)
from wva_tpu_torch.analyzers.queueing.queue_model import (
    CandidateBatch,
    candidate_batch,
)


def candidate_batch_from_numpy(fields: Mapping[str, np.ndarray],
                               device=None) -> CandidateBatch:
    """The port's CandidateBatch from the fields of a JAX ``CandidateBatch``
    (same names, as numpy arrays), on ``device`` (None = the CUDA card)."""
    return candidate_batch(
        fields["alpha"], fields["beta"], fields["gamma"],
        fields["avg_input_tokens"], fields["avg_output_tokens"],
        fields["max_batch"], fields["k"], device=device)


def profile_store_from_records(
        records: Iterable[Mapping]) -> PerfProfileStore:
    """A PerfProfileStore from plain profile records: mappings with
    ``model_id``, ``accelerator``, ``alpha``, ``beta``, ``gamma`` and
    optionally ``namespace``, ``max_batch_size``, ``max_queue_size``,
    ``max_num_tokens`` and ``source``."""
    store = PerfProfileStore()
    defaults = PerfProfile()
    for r in records:
        store.put(PerfProfile(
            model_id=r["model_id"],
            accelerator=r["accelerator"],
            namespace=r.get("namespace", ""),
            service_parms=ServiceParms(alpha=float(r["alpha"]),
                                       beta=float(r["beta"]),
                                       gamma=float(r["gamma"])),
            max_batch_size=int(r.get("max_batch_size",
                                     defaults.max_batch_size)),
            max_queue_size=int(r.get("max_queue_size",
                                     defaults.max_queue_size)),
            max_num_tokens=int(r.get("max_num_tokens",
                                     defaults.max_num_tokens)),
            source=r.get("source", defaults.source),
        ))
    return store
