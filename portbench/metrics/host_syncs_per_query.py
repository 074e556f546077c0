"""host_syncs_per_query: repro_torch.hostsync.read.count over the window,
divided by the queries (the port's own count of device-to-host reads)."""


def read(run):
    if not run.walls:
        return None
    return run.host_syncs / len(run.walls)
