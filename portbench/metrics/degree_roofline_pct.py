"""degree_roofline_pct: the degree count's need over the H100's HBM
bandwidth, as a share of the traced device time of the kernels that
compute the degrees.

The need is 12 bytes for each edge alive at a pass (src, dst, weight) and
4 for each alive node, per pass and lane, from the reference's replay of
the query (``roofline.degree_need_bytes``), times the queries in the
trace.  The need is the query's, whatever implements the count; the time
is that of the kernels named below, by backend, plus any kernel whose name
holds ``degree``.  The mask gathers that feed the count are not in it.

KERNELS names today's kernels.  A program that renames or replaces one
has to be named here by a change to the benchmark: a traced window with
device work and no kernel of the cell's backend raises ``LookupError``
(the run then prints no result), and does not read a share of nothing.
"""

from portbench import roofline

KERNELS = {
    "exact": ("indexFuncLargeIndex", "indexFuncSmallIndex"),  # index_add_ in core/engine.py
    "pallas": ("tiled_degree_kernel",),  # K1, kernels/peel_degree
}
ANY_BACKEND = ("degree",)


def read(run):
    if run.trace is None:
        return None
    backend = run.traffic["problem"].get("backend", "exact")
    names = KERNELS.get(backend, ()) + ANY_BACKEND
    seconds = run.trace.device_s(names)
    if seconds <= 0:
        top = sorted(run.trace.device_s_by_name, key=run.trace.device_s_by_name.get)[-5:]
        raise LookupError(
            f"degree_roofline_pct: no kernel of backend {backend!r} ({', '.join(names)}) in the "
            f"traced window; its longest device ops: {top}. Name the degree kernel in KERNELS "
            "of portbench/metrics/degree_roofline_pct.py")
    need = roofline.degree_need_bytes(run.work) * run.trace.queries
    return roofline.share_pct(need, seconds)
