"""prover.fold_ms: ``recursion.fold``, the prover's fold of its base
proof inside ``prover.prove_recursive`` (the digit witness of the
opening, beta', and the folded statement: the base's aggregates, c_i
c_j, sum_i c_i phi_i, the F' row), per proof, between device syncs,
outside the profiled steps."""

PROBES = [{"target": "labrador_tpu_torch.recursion.fold",
           "span": "prover.fold"}]


def read(rec):
    d = rec.spans.get("prover.fold")
    return 1e3 * sum(d) / len(d) if d else None
