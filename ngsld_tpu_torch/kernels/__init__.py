"""Hand-written CUDA kernels (csrc/) and their wrappers."""


def launch_counts() -> dict:
    """This process's kernel launches so far, by the wrappers' counters:
    pair_em.cu, pair_em_rows.cu, pair_em_ichunk.cu (either body; the
    streamed one also apart), strip_em.cu, strip_em_stream.cu."""
    from . import pair_em, strip_em
    return dict(pair_em=pair_em.LAUNCHES, pair_em_rows=pair_em.LAUNCHES_ROWS,
                pair_em_ichunk=pair_em.LAUNCHES_ICHUNK,
                pair_em_ichunk_stream=pair_em.LAUNCHES_ICHUNK_STREAM,
                strip_em=strip_em.LAUNCHES,
                strip_em_stream=strip_em.LAUNCHES_STREAM)
