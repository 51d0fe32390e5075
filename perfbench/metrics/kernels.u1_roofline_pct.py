"""kernels.u1_roofline_pct: the u1 B-term kernel (``csrc/u1.cu`` on
``mma_stream.cuh``, launched by ``ops/u1_cuda.u1_bterm``) against its
least time, over the profiled steps of a traced run: rows kappa_1, one
stream over r * t_1 * kappa ring elements of B (``lib/roofline``)."""

import math

from perfbench.lib import roofline


def describe(crs, t_dig, col0=0, ncols=None):
    p = crs.params
    ncols = p.kappa if ncols is None else ncols
    lead = t_dig.shape[:-4]
    return {"rows": p.kappa_1, "length": p.t_1 * p.r * ncols, "d": p.d,
            "instances": math.prod(lead)}


PROBES = [{"target": "labrador_tpu_torch.protocol.u1_bterm",
           "span": "kernels.u1", "timed": False, "describe": describe}]


def read(rec):
    return roofline.share(rec, "kernels.u1", "U1Offset")
