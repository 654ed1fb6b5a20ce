"""Query registration settings (:mod:`.slo`)."""
