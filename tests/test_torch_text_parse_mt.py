"""The gz-text loader's parallel parse (ngsld_tpu_torch/loaders.py,
_text_slabs) on the CPU: the reader thread inflates pieces and their
whole-line slices parse on a pool of threads. Its records are bit-equal to
the one-thread parse (native.parse_geno_text_native over the whole text)
at every thread count from 1 to 8, and to strict.read_geno's on LF text,
with piece boundaries at every line of a small fixture (NGSLD_SLAB_BYTES
caps the piece) and pieces shorter than a line; on Beagle with a header,
called genotypes without one, and CRLF ends with header-like and empty
lines and no final newline. Its errors are strict.read_geno's, the first in
file order whichever slice holds it, and 'premature EOF' / 'not at EOF'
fall where read_geno puts them at slice and piece boundaries."""

import gzip

import numpy as np
import pytest
import torch

from ngsld_tpu_torch import loaders, native, strict
from ngsld_tpu_torch.cli import params_from_args
from ngsld_tpu_torch.utils.logging import RunLog
from ngsld_tpu_torch.utils.simulate import simulate, write_all

N_IND, N_SITES = 4, 40
LOADER = loaders._StreamedTextLoader
FEW = "ERROR: [read_geno] wrong GENO file format. Less fields than expected!"
CODE = ("ERROR: [read_geno] wrong GENO file format. Genotypes must be coded "
        "as {-1,0,1,2} !")
NOT_EOF = ("ERROR: [read_geno] GENO file not at EOF. Check GENO file and "
           "number of sites!")
PREMATURE = ("ERROR: [read_geno] GENO file at premature EOF. Check GENO file "
             "and number of sites!")


@pytest.fixture(autouse=True)
def small_slices(monkeypatch):
    if native.get_lib() is None:
        pytest.skip("no g++/zlib on this host: the text loader is declined")
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    monkeypatch.delenv("NGSLD_SLAB_BYTES", raising=False)
    # slices of any size: a fixture of a few kB parses in several
    monkeypatch.setattr(LOADER, "MIN_SLICE_BYTES", 1)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def texts(tmp_path_factory):
    """Decompressed bodies: Beagle probs with a header, called genotypes
    without one, and Beagle with CRLF ends, a short numeric line before
    the first record (a header by the first-site rule), a blank line of
    spaces (a header anywhere), an empty line (a record of the reference's
    sentinel) and no final newline."""
    d = tmp_path_factory.mktemp("parse_mt")
    files = write_all(simulate(n_ind=N_IND, n_sites=N_SITES, seed=41,
                               mono_rate=0.05), str(d))
    with gzip.open(files["beagle"], "rb") as fh:
        beagle = fh.read()
    with gzip.open(files["geno_text"], "rb") as fh:
        geno = fh.read()
    lines = beagle.split(b"\n")[:-1]
    quirks = [lines[0], b"0.5 0.25"] + lines[1:20] + [b"  \t "] \
        + lines[20:30] + [b""] + lines[30:]
    return {"beagle": (beagle, True, N_SITES, files["pos"]),
            "geno": (geno, False, N_SITES, files["pos"]),
            "quirks": (b"\r\n".join(quirks), True, N_SITES + 1,
                       files["pos"])}


def _write(tmp_path, body, name="in.gz"):
    path = tmp_path / name
    with gzip.open(path, "wb") as fh:
        fh.write(body)
    return str(path)


def _pars(path, probs, n_sites, pos):
    return params_from_args(["--geno", path, *(["--probs"] if probs else []),
                             "--n_ind", str(N_IND), "--n_sites", str(n_sites),
                             "--pos", pos, "--verbose", "0"])


def _load(monkeypatch, p, dt, threads, piece=None):
    """The loader's table (numpy) and its RunLog."""
    monkeypatch.setattr(LOADER, "PARSE_THREADS", threads)
    if piece:
        monkeypatch.setenv("NGSLD_SLAB_BYTES", str(piece))
    else:
        monkeypatch.delenv("NGSLD_SLAB_BYTES", raising=False)
    log = RunLog(0)
    return LOADER(p, dt, "cpu", log=log).join().numpy(), log


def _error(fn):
    with pytest.raises(strict.StrictError) as e:
        fn()
    return str(e.value)


def _parse_rows(monkeypatch, p, threads):
    """The records of each parse _text_slabs makes of a file of one
    piece, in file order (by their text's addresses): the head up to the
    file's first record, then one a slice."""
    monkeypatch.setattr(LOADER, "PARSE_THREADS", threads)
    calls, parse = [], native.parse_geno_text_to

    def record(addr, *args):
        got = parse(addr, *args)
        calls.append((addr, got[0]))
        return got

    with monkeypatch.context() as mp:
        mp.setattr(native, "parse_geno_text_to", record)
        list(loaders._text_slabs(p, np.float64, LOADER.CHUNK_BYTES,
                                 RunLog(0), "t"))
    return [got for _, got in sorted(calls)]


@pytest.mark.parametrize("threads", range(1, 9))
def test_records_equal_the_one_thread_parse(texts, tmp_path, monkeypatch,
                                            threads):
    for key, (body, probs, n, pos) in texts.items():
        path = _write(tmp_path, body, f"{key}.gz")
        p = _pars(path, probs, n, pos)
        # the one-thread parse of the whole text, today's loader's
        ref, used = native.parse_geno_text_native(body, probs, False, N_IND,
                                                  0, n)
        assert len(ref) == n and used == len(body)
        if key != "quirks":   # read_geno chomps one byte of a CRLF end
            np.testing.assert_array_equal(ref, strict.read_geno(
                path, False, probs, False, N_IND, n))
        want = {np.float64: ref.view(np.uint64),
                np.float32: ref.astype(np.float32).view(np.uint32)}
        # one piece, then a piece boundary after every line, and pieces
        # shorter than a line (the buffer grows)
        ends = [i + 1 for i, c in enumerate(body) if c == ord("\n")]
        for k, piece in enumerate([None, 16, 100] + ends):
            dt = (np.float32, np.float64)[k % 2]
            got, log = _load(monkeypatch, p, dt, threads, piece)
            assert got.dtype == dt
            np.testing.assert_array_equal(
                got.view(want[dt].dtype), want[dt], err_msg=f"{key} {piece}")
            assert log.counters["parse_threads"] == threads
            if piece is None:   # one piece of whole-line slices
                assert log.counters["parse_slices"] == threads


def _spoil(body, probs, row, short):
    """The body with record `row` spoiled: three fields short (the label
    columns are numeric too), or its last genotype coded 3."""
    lines = body.split(b"\n")
    i = row + (1 if probs else 0)   # past the Beagle header
    toks = lines[i].split(b"\t")
    if short:
        toks = toks[:-3]
    else:
        toks[-1] = b"3"
    lines[i] = b"\t".join(toks)
    return b"\n".join(lines)


def _slice_starts(monkeypatch, tmp_path, text, threads=4):
    """Each parse's first record (the head's, then each slice's) and the
    total, on the unspoiled file."""
    body, probs, n, pos = text
    rows = _parse_rows(monkeypatch, _pars(_write(tmp_path, body), probs, n,
                                         pos), threads)
    assert len(rows) == threads + 1   # the head and the slices
    return [int(x) for x in np.cumsum([0] + rows)]


@pytest.mark.parametrize("key", ["beagle", "geno"])
@pytest.mark.parametrize("where", ["first", "middle", "last",
                                   "past_n_sites"])
def test_bad_line_raises_read_genos_error(texts, tmp_path, monkeypatch, key,
                                          where):
    """A bad line in the first, a middle (at its first line) or the last
    slice, or after the n_sites-th record: strict.read_geno's error, the
    native and the Python reader's alike, at 1 and at 4 threads."""
    body, probs, n, pos = texts[key]
    start = _slice_starts(monkeypatch, tmp_path, texts[key])
    row = {"first": start[1] + 1, "middle": start[3], "last": start[5] - 1,
           "past_n_sites": n - 3}[where]
    path = _write(tmp_path, _spoil(body, probs, row, probs), "bad.gz")
    n_read = n - 4 if where == "past_n_sites" else n
    msg = _error(lambda: strict.read_geno(path, False, probs, False, N_IND,
                                          n_read))
    monkeypatch.setenv("NGSLD_NO_NATIVE", "1")
    assert _error(lambda: strict.read_geno(
        path, False, probs, False, N_IND, n_read)) == msg
    monkeypatch.delenv("NGSLD_NO_NATIVE")
    assert msg == (NOT_EOF if where == "past_n_sites" else
                   FEW if probs else CODE)
    p = _pars(path, probs, n_read, pos)
    for threads in (1, 4):
        assert _error(lambda: _load(monkeypatch, p, np.float32,
                                    threads)) == msg


@pytest.mark.parametrize("order", ["code_first", "short_first"])
def test_two_bad_lines_raise_the_first(texts, tmp_path, monkeypatch, order):
    """Called genotypes with a code 3 and a short line in different
    slices: whichever comes first in the file is the error, at every
    thread count (the later slice may finish first)."""
    body, probs, n, pos = texts["geno"]
    start = _slice_starts(monkeypatch, tmp_path, texts["geno"])
    a, b = start[1] + 1, start[4] + 1
    code_row, short_row = (a, b) if order == "code_first" else (b, a)
    path = _write(tmp_path, _spoil(_spoil(body, probs, code_row, False),
                                   probs, short_row, True), "two.gz")
    msg = _error(lambda: strict.read_geno(path, False, probs, False, N_IND,
                                          n))
    assert msg == (CODE if order == "code_first" else FEW)
    p = _pars(path, probs, n, pos)
    for threads in range(1, 9):
        assert _error(lambda: _load(monkeypatch, p, np.float64,
                                    threads)) == msg


@pytest.mark.parametrize("boundary", ["slice", "piece"])
def test_eof_errors_at_boundaries(texts, tmp_path, monkeypatch, boundary):
    """n_sites ending at a slice's or a piece's last record: 'not at EOF'
    (the next slice's or piece's bytes follow); a file ending at that
    boundary with one site more asked: 'premature EOF'; exactly its
    records: read_geno's table."""
    body, probs, n, pos = texts["beagle"]
    path = _write(tmp_path, body)
    ends = [i + 1 for i, c in enumerate(body) if c == ord("\n")]
    if boundary == "slice":   # one piece: the head and four slices
        piece = None
        rows = _parse_rows(monkeypatch, _pars(path, probs, n, pos), 4)
        assert len(rows) == 5
        cut = sum(rows[:3])   # the head and two slices
    else:
        piece = ends[17]   # the first piece: the header and 17 records
        cut = 17
    msg = _error(lambda: strict.read_geno(path, False, probs, False, N_IND,
                                          cut))
    assert msg == NOT_EOF
    p = _pars(path, probs, cut, pos)
    assert _error(lambda: _load(monkeypatch, p, np.float32, 4, piece)) == msg
    # the file cut after those records
    short = _write(tmp_path, body[:ends[cut]], "short.gz")
    for n_sites, err in ((cut + 1, PREMATURE), (cut, None)):
        p = _pars(short, probs, n_sites, pos)
        if err is None:
            got, _ = _load(monkeypatch, p, np.float64, 4, piece)
            np.testing.assert_array_equal(got, strict.read_geno(
                short, False, probs, False, N_IND, cut))
            continue
        assert _error(lambda: strict.read_geno(
            short, False, probs, False, N_IND, n_sites)) == err
        assert _error(lambda: _load(monkeypatch, p, np.float32, 4,
                                    piece)) == err
