"""B1 (nfw_uk_kernel)'s share of its roofline: the least time its work can
take (portbench/work/nfw_uk.py, counted on each call's own inputs, worked
out by the configuration's reference) over its device time, on the first
two traced calls."""

from portbench.work import nfw_uk

from portbench.metrics._roofline import share


def read(trace):
    return share(trace, nfw_uk.KERNEL,
                 lambda ks, s, c: nfw_uk.work(ks, s.reshape(-1),
                                              c.reshape(-1)))
