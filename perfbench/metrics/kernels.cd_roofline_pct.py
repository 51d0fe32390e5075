"""kernels.cd_roofline_pct: the C/D-sum kernel (``csrc/cd.cu`` on
``mma_stream.cuh``, launched by ``ops/cd_cuda.cd_sum``: u1's C-term and
u2) against its least time, over the profiled steps of a traced run:
rows kappa_2, one stream over the (i <= j, k) digits (``lib/roofline``)."""

import math

from perfbench.lib import roofline


def describe(crs, dig_stream, base_off, t_used, digit_base=0, l0=0,
             length=None):
    p = crs.params
    full = dig_stream.shape[-3] * dig_stream.shape[-2]
    return {"rows": p.kappa_2, "length": full if length is None else length,
            "d": p.d, "instances": math.prod(dig_stream.shape[:-3])}


PROBES = [{"target": "labrador_tpu_torch.protocol.cd_sum",
           "span": "kernels.cd", "timed": False, "describe": describe}]


def read(rec):
    return roofline.share(rec, "kernels.cd", "CdOffset")
