"""B2 (nfw_contract_kernel)'s share of its roofline: the least time its
work can take (portbench/work/nfw_contract.py, counted on each call's own
inputs, worked out by the configuration's reference) over its device
time, on the first two traced calls."""

from portbench.work import nfw_contract

from portbench.metrics._roofline import share


def read(trace):
    return share(trace, nfw_contract.KERNEL, nfw_contract.work)
