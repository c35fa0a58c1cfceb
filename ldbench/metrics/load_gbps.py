"""load_gbps: the input loaders' own pace (loaders.py), GB/s: the GENO
file's bytes as stored (counter load_bytes; gz bytes for Beagle text)
over the reader thread's seconds reading and parsing them (stages `load:
read` and `load: parse`), its waits on a full slab queue left out; summed
over the window's jobs."""

STAGES = ("load: read", "load: parse")


def read(run):
    jobs = [j for j in run.jobs if "load_bytes" in j["counters"]]
    secs = sum(j["stages"].get(k, 0.0) for j in jobs for k in STAGES)
    if secs <= 0:
        return None
    return sum(j["counters"]["load_bytes"] for j in jobs) / secs / 1e9
