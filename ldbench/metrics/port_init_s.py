"""port_init_s: seconds of the port's own set-up in the process (the
window's first job's "process" spans): its import with the first vector
math calls (`init: import`), the native host library's load (`init:
native lib`) and each kernel library's (`init: kernel lib <name>`). The
builds (`init: native build`, `init: kernel build`) are left out: a
checkout's first run pays them, and counter kernel_libs_built says
whether one ran."""


def _counted(name: str) -> bool:
    return name in ("init: import", "init: native lib") \
        or name.startswith("init: kernel lib ")


def read(run):
    if not run.jobs or "process" not in run.jobs[0]:
        return None
    spans = [s for s in run.jobs[0]["process"]["spans"]
             if _counted(s[0]) and s[4] is not None]
    if not spans:
        return None
    return sum(s[4] - s[3] for s in spans) / 1e6
