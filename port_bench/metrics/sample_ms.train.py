"""Sampler: the host time a traced step spends inside the program's span
``irt.train.sample`` (the batch draws: the main and the auxiliary
``sample_bpr_batch`` for IGCN and DOSE_aug), in ms a step."""

from port_bench.core import spans


def read(run):
    return spans.ms_per_unit(run.trace, "irt.train.sample")
