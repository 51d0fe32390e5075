"""verifier.commit_checks_ms: the sections c15_az_vs_ct, c19_u1 and
c20_u2 of ``verifier.verify_report`` (its ``timer=``, the program's
``utils/profiling.PhaseTimer``: device syncs around each), the checks that
re-expand the CRS through the commitment kernels, per verify, outside
the profiled steps."""

SECTIONS = ("c15_az_vs_ct", "c19_u1", "c20_u2")


def read(rec):
    if rec.timed_verifies <= 0 or not all(s in rec.sections
                                          for s in SECTIONS):
        return None
    return 1e3 * sum(rec.sections[s] for s in SECTIONS) / rec.timed_verifies
