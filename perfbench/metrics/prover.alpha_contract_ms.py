"""prover.alpha_contract_ms: the folded prover's alpha-contraction
(``prover.folded_phi_alpha``: ``recursion.FoldedState.phi_alpha_modq``,
the base CRS's A, B, C and D re-expanded by ``_alpha_contract_a/_b/_cd``
and contracted with alpha, in phase 2b of the folded prove), per call
(one a step), between device syncs, outside the profiled steps."""

PROBES = [{"target": "labrador_tpu_torch.prover.folded_phi_alpha",
           "span": "prover.alpha_contract"}]


def read(rec):
    d = rec.spans.get("prover.alpha_contract")
    return 1e3 * sum(d) / len(d) if d else None
