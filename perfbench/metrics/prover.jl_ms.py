"""prover.jl_ms: phase 2a of the prover (``prover.prove_phase2a``: the JL
matrices, through the SHA-256 stream under Fiat-Shamir and Threefry
``sample_jl`` otherwise, the projection and its retries, the oracle's
absorbs), per proof, between device syncs, outside the profiled steps."""

PROBES = [{"target": "labrador_tpu_torch.prover.prove_phase2a",
           "span": "prover.phase2a"}]


def read(rec):
    d = rec.spans.get("prover.phase2a")
    return 1e3 * sum(d) / len(d) if d else None
