"""prover.agg_ms: phase 2b of the prover (``prover.prove_phase2b``: both
aggregations, h and the u2 commitment), per proof, between device
syncs, outside the profiled steps."""

PROBES = [{"target": "labrador_tpu_torch.prover.prove_phase2b",
           "span": "prover.phase2b"}]


def read(rec):
    d = rec.spans.get("prover.phase2b")
    return 1e3 * sum(d) / len(d) if d else None
