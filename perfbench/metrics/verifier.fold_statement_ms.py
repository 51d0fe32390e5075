"""verifier.fold_statement_ms: the section fold_statement of
``verifier.verify_recursive`` (its ``timer=``, the program's
``utils/profiling.PhaseTimer``: device syncs around it), the folded
statement rebuilt from the base transcript's public fields, per verify,
outside the profiled steps."""

SECTION = "fold_statement"


def read(rec):
    if rec.timed_verifies <= 0 or SECTION not in rec.sections:
        return None
    return 1e3 * rec.sections[SECTION] / rec.timed_verifies
