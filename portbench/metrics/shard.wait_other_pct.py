"""On a mesh, the share of the traced window in which a card runs nothing
while the one host thread is inside another slot's
``hmvec.shard.issue:<i>`` span: the time a card waits for the others'
issue, the mean over the cell's cards."""

from portbench.lib import spans


def read(trace):
    def others(i):
        return spans.host_ranges(
            trace, lambda name: spans.shard_index(name) not in (None, i))

    return spans.idle_under_pct(trace, others)
