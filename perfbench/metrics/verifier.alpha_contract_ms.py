"""verifier.alpha_contract_ms: the section alpha_contract of the folded
``verifier.verify_report`` inside ``verifier.verify_recursive`` (its
``timer=``, the program's ``utils/profiling.PhaseTimer``: device syncs
around it): ``recursion.FoldedState.phi_alpha_modq``, the base CRS's A,
B, C and D re-expanded and contracted with alpha for the folded
aggregates, per verify, outside the profiled steps."""

SECTION = "alpha_contract"


def read(rec):
    if rec.timed_verifies <= 0 or SECTION not in rec.sections:
        return None
    return 1e3 * rec.sections[SECTION] / rec.timed_verifies
