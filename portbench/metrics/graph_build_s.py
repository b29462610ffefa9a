"""graph_build_s (s): host seconds of set-up in the program's
``graph_build`` spans (``train/runner.py:build_split_graphs``: the contact
file, the adjacency and the operator's host build with the cost model),
since the process started."""

from portbench import spans


def read(session):
    return spans.total_host_s("graph_build")
