"""idle_protocol_ms: card-idle milliseconds per LM iteration while the host
was in the GST protocol's own code (spans `fit`, `fit.layout` and
`objective.build`: the layout, the counts' upload, retrieve_model, the
degrees of freedom, the results, model copies), from the join of the
program's spans with the device trace (spans.py)."""

from gstbench import spans


def read(rec):
    return spans.idle_ms_per_step(rec, ('fit', 'fit.layout', 'objective.build'))
