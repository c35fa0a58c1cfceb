"""Ranks of a multi-device run over torch.distributed
(ngsld_tpu/parallel/mesh.py: make_mesh, init_distributed).

One process (rank) drives one device. World size = shard x shard_ind;
rank r sits at (r // shard_ind, r % shard_ind) on the ('pairs', 'ind')
mesh of the reference, which the ring reads as ('sites', 'ind'): the
first coordinate is then the rank's site block. Three kinds of group:

  * the default group: the device collectives that every rank joins (the
    broadcast of the site tables, the ring's exchange between the blocks
    of one 'ind' column);
  * one subgroup per 'pairs' row (--shard_ind > 1): the 'ind' all-reduces
    of the EM and of the Pearson moments;
  * a gloo group over every rank: host-side traffic (each row's result
    piece to rank 0, the checkpoint's done set, small host objects).

The device collectives run over NCCL when every rank of the node has a
card of its own, and over gloo on the CPU and where ranks share a card
(NCCL refuses two ranks on one device). The choice is made from the
topology before any collective runs; a failed NCCL set-up is an error,
never a retry on gloo.

Launch: under a launcher (RANK and WORLD_SIZE set, as torchrun sets them)
a rank joins the launched group through MASTER_ADDR/MASTER_PORT. Without
one, the calling process becomes rank 0 and starts ranks 1..N-1 itself
(start_ranks): spawned processes (never forked: a forked CUDA context is
unusable) that meet at a TCP store on a free port of this host. Rank 0
watches them; a rank that exits non-zero ends the others and fails the
run. Every group has a timeout (NGSLD_DIST_TIMEOUT seconds, 600 by
default), so a rank that dies cannot leave the others blocked forever.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

# rank 0 of a self-started run serves the store here
HOST = "127.0.0.1"
_READY = "ngsld/ready/"
_FAILED = "ngsld/failed/"


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(os.environ.get("NGSLD_DIST_TIMEOUT", "600")))


@dataclasses.dataclass
class Mesh:
    """This rank's place on the ('pairs', 'ind') mesh and its groups.

    allreduces / allreduce_s count the 'ind' all-reduces and their host
    seconds (on NCCL only the enqueue, the device runs them later);
    gather_s is rank 0's host seconds receiving the other rows' pieces;
    ring_exchanges / ring_exchange_s / ring_exchange_bytes count the
    ring's shifts (ring_shift), their host seconds and the bytes this
    rank sent."""
    rank: int
    world: int
    shard: int
    shard_ind: int
    device: torch.device
    backend: str                 # the device collectives: "nccl" | "gloo"
    shared: bool                 # ranks of the node share a card
    local_world: int = 0         # ranks on this rank's node (0: world)
    ind_group: object = None     # this rank's 'pairs' row (shard_ind > 1)
    host_group: object = None    # gloo, every rank
    allreduces: int = 0
    allreduce_s: float = 0.0
    gather_s: float = 0.0
    ring_exchanges: int = 0
    ring_exchange_s: float = 0.0
    ring_exchange_bytes: int = 0
    _stage: tuple = ()           # pinned host buffers of a staged shift

    @property
    def nodes(self) -> bool:
        """The ranks span several nodes (a launcher's LOCAL_WORLD_SIZE
        below its WORLD_SIZE): no directory is known to be shared."""
        return 0 < self.local_world < self.world

    @property
    def pi(self) -> int:
        """Coordinate on the 'pairs' axis (the row)."""
        return self.rank // self.shard_ind

    @property
    def ii(self) -> int:
        """Coordinate on the 'ind' axis."""
        return self.rank % self.shard_ind

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum t in place over this rank's 'pairs' row (the 'ind' axis)."""
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.ind_group)
        self.allreduce_s += time.perf_counter() - t0
        self.allreduces += 1
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's t into every rank's t (device tensors, default group)."""
        dist.broadcast(t, 0)
        return t

    def broadcast_object(self, obj):
        """Rank 0's picklable obj on every rank (host group)."""
        box = [obj]
        dist.broadcast_object_list(box, 0, group=self.host_group)
        return box[0]

    def all_gather_object(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def host_reduce(self, x: int, op: str = "max") -> int:
        """An integer's max or min over every rank (host group)."""
        t = torch.tensor([int(x)], dtype=torch.int64)
        dist.all_reduce(t, op=dict(max=dist.ReduceOp.MAX,
                                   min=dist.ReduceOp.MIN)[op],
                        group=self.host_group)
        return int(t)

    def ring_shift(self, tensors, offset: int = 1, out=None) -> tuple:
        """jax.lax.ppermute(v, 'sites', [(k, (k - offset) % n) ...]) over
        this rank's 'ind' column: the rank at block i receives the tensors
        of block (i + offset) % n and sends its own to block
        (i - offset) % n. Returns the received tensors: `out` (contiguous
        tensors shaped as `tensors`, filled in place) or new ones. At one
        block, or where offset % n == 0, it is the identity and calls
        nothing.

        Every send and receive of a shift is posted at once
        (batch_isend_irecv): a blocking send-then-receive around a ring
        deadlocks under NCCL. NCCL moves the device tensors directly;
        gloo's point-to-point operations take CPU tensors, so on a card
        (ranks that share it) each shift goes through one pinned host
        buffer a direction, allocated once and grown as needed. A shift
        that fails ends the run with an error naming this rank."""
        n = self.shard
        tensors = tuple(tensors)
        if n == 1 or offset % n == 0:
            return tensors
        M = self.shard_ind
        dst = ((self.pi - offset) % n) * M + self.ii
        src = ((self.pi + offset) % n) * M + self.ii
        t0 = time.perf_counter()
        send = [t.contiguous() for t in tensors]
        recv = ([torch.empty_like(t) for t in send] if out is None
                else list(out))
        assert all(r.is_contiguous() and r.shape == t.shape
                   and r.dtype == t.dtype for r, t in zip(recv, send))
        nbytes = sum(t.numel() * t.element_size() for t in send)
        staged = self.backend == "gloo" and send[0].device.type != "cpu"
        try:
            if staged:
                s_buf, r_buf = self._staging(nbytes)
                off = 0
                for t in send:
                    k = t.numel() * t.element_size()
                    s_buf[off:off + k].copy_(t.reshape(-1).view(torch.uint8))
                    off += k
                ops = [dist.P2POp(dist.isend, s_buf[:nbytes], dst),
                       dist.P2POp(dist.irecv, r_buf[:nbytes], src)]
            else:
                ops = ([dist.P2POp(dist.isend, t, dst) for t in send]
                       + [dist.P2POp(dist.irecv, r, src) for r in recv])
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            if staged:
                off = 0
                for r in recv:
                    k = r.numel() * r.element_size()
                    r.reshape(-1).view(torch.uint8).copy_(r_buf[off:off + k])
                    off += k
        except RuntimeError as e:
            raise RuntimeError(
                f"rank {self.rank}: ring exchange (offset {offset}: to rank "
                f"{dst}, from rank {src}) failed: {e}") from e
        self.ring_exchanges += 1
        self.ring_exchange_s += time.perf_counter() - t0
        self.ring_exchange_bytes += nbytes
        return tuple(recv)

    def _staging(self, nbytes: int):
        """(send, receive) pinned uint8 host buffers of at least nbytes."""
        if not self._stage or self._stage[0].numel() < nbytes:
            self._stage = tuple(
                torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                for _ in range(2))
        return self._stage

    def send_rows(self, arrays) -> None:
        """Send host arrays to rank 0 as one byte buffer (host group); rank
        0 knows their shapes and dtypes (recv_rows)."""
        buf = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(
            np.uint8) for a in arrays]) if arrays else np.empty(0, np.uint8)
        if buf.size:
            dist.send(torch.from_numpy(buf), dst=0, group=self.host_group)

    def recv_rows(self, src: int, n: int, like) -> list:
        """The arrays src sent with send_rows: n rows each, dtype and
        columns from `like` (arrays of the same layout)."""
        t0 = time.perf_counter()
        sizes = [n * int(np.prod(a.shape[1:])) * a.dtype.itemsize
                 for a in like]
        buf = torch.empty(sum(sizes), dtype=torch.uint8)
        if buf.numel():
            dist.recv(buf, src=src, group=self.host_group)
        raw = buf.numpy()
        out, off = [], 0
        for a, nb in zip(like, sizes):
            out.append(raw[off:off + nb].view(a.dtype).reshape(
                (n,) + a.shape[1:]))
            off += nb
        self.gather_s += time.perf_counter() - t0
        return out


def launched():
    """The launcher's view of this process (rank, world, local_rank,
    local_world) when RANK and WORLD_SIZE are set, else None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    return dict(rank=int(os.environ["RANK"]), world=world,
                local_rank=int(os.environ.get("LOCAL_RANK", "0")),
                local_world=int(os.environ.get("LOCAL_WORLD_SIZE",
                                               str(world))))


def rank_device(cpu: bool, local_rank: int) -> torch.device:
    """A rank's device: the CPU, or card LOCAL_RANK (modulo the node's
    cards, so ranks past the card count share one)."""
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def pick_backend(device: torch.device, local_world: int):
    """(backend of the device collectives, whether ranks share a card):
    NCCL when every rank of the node has its own card, else gloo."""
    if device.type != "cuda":
        return "gloo", False
    shared = local_world > torch.cuda.device_count()
    return ("gloo" if shared else "nccl"), shared


def connect(rank: int, world: int, shard: int, shard_ind: int,
            device: torch.device, local_world: int, store=None) -> Mesh:
    """Join the process group (through `store`, or the launcher's
    MASTER_ADDR/MASTER_PORT) and build the mesh's groups. Every rank calls
    this with the same shard x shard_ind."""
    assert shard * shard_ind == world, (shard, shard_ind, world)
    backend, shared = pick_backend(device, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"store": store} if store is not None else {"init_method": "env://"}
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=_timeout(), **kw)
    return _with_groups(Mesh(rank, world, shard, shard_ind, device,
                             backend, shared, local_world))


def _with_groups(m: Mesh) -> Mesh:
    """m with its groups made on the current process group: the gloo host
    group and, with shard_ind > 1, one 'ind' group a 'pairs' row. Every
    rank creates every group, in the same order."""
    m.host_group = dist.new_group(backend="gloo", timeout=_timeout())
    if m.shard_ind > 1:
        for p in range(m.shard):
            g = dist.new_group(ranks=list(range(p * m.shard_ind,
                                                (p + 1) * m.shard_ind)),
                               timeout=_timeout())
            if p == m.pi:
                m.ind_group = g
    return m


def submesh(m: Mesh, shard: int, shard_ind: int) -> Mesh:
    """Another shard x shard_ind layout of m's ranks on the same process
    group (one init_process_group a process): new groups, the device and
    backend of m. Every rank calls this, in the same order."""
    assert shard * shard_ind == m.world, (shard, shard_ind, m.world)
    return _with_groups(Mesh(m.rank, m.world, shard, shard_ind, m.device,
                             m.backend, m.shared, m.local_world))


def teardown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_main(rank: int, world: int, port: int, job: dict, shard: int,
              shard_ind: int, run) -> None:
    """The body of a self-started rank (a spawned process): join rank 0's
    store and group on the shard x shard_ind mesh, then run(m) on this
    rank's device. An exception is recorded in the store for rank 0 and
    exits the process non-zero."""
    torch.set_num_threads(job["threads"])
    device = rank_device(job["cpu"], rank)
    store = dist.TCPStore(HOST, port, world, False, timeout=_timeout())
    store.set(_READY + str(rank), "1")
    m = connect(rank, world, shard, shard_ind, device, world, store)
    try:
        run(m)
    except BaseException as e:
        # before the group closes: rank 0 sees the closed connections only
        # after this, and names this rank's error, not its own
        store.set(_FAILED + str(rank), f"{type(e).__name__}: {e}")
        raise
    finally:
        teardown()


def _rank_entry(rank: int, world: int, port: int, job: dict) -> None:
    """Entry of a self-started rank of a run: this rank's part of the run
    (the block engine, or the ring) on its device. Only rank 0 writes to
    the run's output."""
    pars = job["pars"]

    def run(m):
        from ..engine import _run_rank   # the engine imports this module
        _run_rank(pars, None, job["prec"], m.device, m)

    rank_main(rank, world, port, job, pars.shard, pars.shard_ind, run)


class _Watcher:
    """Rank 0's view of the ranks it started: the first that exits
    non-zero is recorded and the others are ended."""

    def __init__(self, procs):
        self.procs = procs
        self.failed = None          # (rank, exit code)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="ngsld-rank-watch")
        self._t.start()

    def _run(self):
        while not self._stop.wait(0.1):
            for r, p in enumerate(self.procs, start=1):
                if p.exitcode not in (None, 0):
                    self.failed = (r, p.exitcode)
                    self.end()
                    return

    def end(self):
        for p in self.procs:
            if p.exitcode is None:
                p.terminate()

    def stop(self):
        self._stop.set()
        self._t.join()


@contextlib.contextmanager
def spawn_ranks(world: int, device: torch.device, entry, job: dict):
    """Rank 0's side of a self-started world: serve a store on a free port
    (the OS picks it: parallel runs cannot collide), spawn ranks 1..N-1
    as entry(rank, world, port, job) (a module-level function, which
    calls rank_main), wait until every rank has reached the store, and
    yield the store, which rank 0 then joins the group through. `job`
    gains the ranks' torch thread count ("threads") and whether they run
    on the CPU ("cpu"). On exit every rank has ended: joined after a clean
    exit, ended otherwise. A rank that exited non-zero fails the call
    (StrictError naming it), even where rank 0's own error came first."""
    from ..strict import StrictError
    import torch.multiprocessing as mp
    store = dist.TCPStore(HOST, 0, world, True, timeout=_timeout(),
                          wait_for_workers=False)
    # on the CPU the ranks share the caller's threads (N ranks of torch's
    # one thread a core would thrash the cores); on the card each keeps
    # the caller's count for its host work
    threads = torch.get_num_threads()
    if device.type == "cpu":
        threads = max(1, threads // world)
    job = dict(job, cpu=device.type == "cpu", threads=threads)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=entry, args=(r, world, store.port, job),
                         name=f"ngsld-rank{r}") for r in range(1, world)]
    for p in procs:
        p.start()
    watch = _Watcher(procs)
    own_threads = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        # every rank has reached the store before the group forms, so a
        # rank that dies while starting fails the run here and not at the
        # group's timeout
        deadline = time.monotonic() + _timeout().total_seconds()
        for r in range(1, world):
            while not store.check([_READY + str(r)]):
                if watch.failed or time.monotonic() > deadline:
                    raise RuntimeError(f"rank {r} did not start")
                time.sleep(0.02)
        yield store
    except BaseException as e:
        watch.stop()
        failed = [(r, store.get(_FAILED + str(r)).decode())
                  for r in range(1, world) if store.check([_FAILED + str(r)])]
        watch.end()
        for p in procs:
            p.join()
        if failed:
            raise StrictError("shard", f"rank {failed[0][0]} failed: "
                              f"{failed[0][1]}") from e
        if watch.failed:
            raise StrictError("shard", f"rank {watch.failed[0]} exited with "
                              f"code {watch.failed[1]}") from e
        raise
    else:
        watch.stop()
        # the others leave right after the run's last collective
        for p in procs:
            p.join(_timeout().total_seconds())
        watch.end()
        for p in procs:
            p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs, start=1)
               if p.exitcode != 0]
        if bad:
            raise StrictError("shard", f"rank {bad[0][0]} exited with code "
                              f"{bad[0][1]}")
    finally:
        torch.set_num_threads(own_threads)


@contextlib.contextmanager
def start_ranks(pars, prec: str, device: torch.device):
    """Rank 0 of a run started without a launcher: spawn ranks 1..N-1
    (spawn_ranks, each running _rank_entry), join the group, and yield
    rank 0's Mesh."""
    world = pars.shard * pars.shard_ind
    with spawn_ranks(world, device, _rank_entry,
                     dict(pars=pars, prec=prec)) as store:
        m = connect(0, world, pars.shard, pars.shard_ind, device, world,
                    store)
        try:
            yield m
        finally:
            teardown()
