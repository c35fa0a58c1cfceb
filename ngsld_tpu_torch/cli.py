"""ngsld CLI on the torch engine: the flags of ngsld_tpu/cli.py, unchanged
(the reference's 21 flags, parse_args.cpp:35-59, plus the engine
extensions).

    python -m ngsld_tpu_torch.cli --geno data.beagle.gz --probs \
        --n_ind 24 --n_sites 10000 --pos data.pos --max_kb_dist 10 \
        --min_maf 0.05 --extend_out

--engine strict runs the port's copy of the bit-exact CPU oracle
(strict.py); auto and jax run the torch engine (engine.run_torch), on the
CUDA device unless NGSLD_PLATFORM=cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys

from .config import ConfigError, Params
from .strict import StrictError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ngsld",
        description="Pairwise linkage disequilibrium from genotype likelihoods "
                    "(feature-parity rebuild of ngsLD 1.2.1), PyTorch/CUDA engine.")
    # reference flags (parse_args.cpp:35-59)
    p.add_argument("--geno", "-g", dest="in_geno", help="input GL/genotype file (.gz => text, else binary doubles)")
    p.add_argument("--probs", "-p", action="store_true", dest="in_probs", help="input are genotype likelihoods/probabilities (3 cols/ind)")
    p.add_argument("--log_scale", "-l", action="store_true", dest="in_logscale", help="input probs are log-scaled (implies --probs)")
    p.add_argument("--n_ind", "-n", type=int, default=0)
    p.add_argument("--n_sites", "-s", type=int, default=0)
    p.add_argument("--pos", "-a", dest="in_pos", help="position TSV (chr, pos), no header")
    p.add_argument("--posH", "-A", dest="in_pos_header_file", help="position TSV with a header line")
    p.add_argument("--max_kb_dist", "-d", type=int, default=100, help="max distance between SNPs in kb (0 = no limit) [100]")
    p.add_argument("--max_snp_dist", "-D", type=int, default=0, help="max SNP index distance (0 = no limit)")
    p.add_argument("--min_maf", "-f", type=float, default=0.0)
    p.add_argument("--ignore_miss_data", "-m", action="store_true")
    p.add_argument("--call_geno", "-c", action="store_true")
    p.add_argument("--N_thresh", "-N", type=float, default=0.0)
    p.add_argument("--call_thresh", "-C", type=float, default=0.0)
    p.add_argument("--rnd_sample", "-r", type=float, default=1.0)
    p.add_argument("--seed", "-S", type=int, default=None)
    p.add_argument("--extend_out", "-x", action="store_true")
    p.add_argument("--out", "-o", default=None, help="output TSV [stdout]")
    p.add_argument("--n_threads", "-t", type=int, default=1, help="host worker threads (compat; device engine ignores)")
    p.add_argument("--verbose", "-V", type=int, default=1)
    # engine extensions
    p.add_argument("--engine", choices=["auto", "jax", "strict"], default="auto",
                   help="auto, jax: the torch engine (CUDA; NGSLD_PLATFORM=cpu for the CPU); "
                        "strict: bit-exact reference-concordant CPU engine")
    p.add_argument("--precision", choices=["auto", "f32", "f64"], default="auto",
                   help="EM precision for the torch engine (auto: f32 on CUDA, f64 on CPU)")
    p.add_argument("--chunk_pairs", type=int, default=1 << 19,
                   help="pairs per device batch for the torch engine")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR "
                        "(one Chrome trace, *.pt.trace.json)")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="make the run resumable via shards in DIR: per-block "
                        "output TSVs (block engine) or per-ring-step .npz "
                        "state (--ring); rerunning with the same config "
                        "computes only what is missing")
    p.add_argument("--shard", type=int, default=1, metavar="N",
                   help="split each pair block across N local devices "
                        "(0 = all; 1 = single-device) [1]")
    p.add_argument("--shard_ind", type=int, default=1, metavar="N",
                   help="split the INDIVIDUAL axis across N devices "
                        "(cohorts too large for one device's VMEM/HBM; "
                        "per-individual EM reductions become psums) [1]")
    p.add_argument("--ring", action="store_true",
                   help="site-sharded ring sweep over the --shard mesh: the "
                        "GL table stays sharded by site block and partner "
                        "blocks ride the ring (for tables too large to "
                        "replicate per device)")
    p.add_argument("--ring_sub", type=int, default=0, metavar="N",
                   help="ring sub-blocks per device block: bounds the "
                        "per-step stat tile to (block x block/N) and skips "
                        "out-of-band sub-rings [0 = auto, ~4k sites each]")
    return p


def params_from_args(argv) -> Params:
    args = build_parser().parse_args(argv)
    pars = Params(
        in_geno=args.in_geno, in_probs=args.in_probs, in_logscale=args.in_logscale,
        n_ind=args.n_ind, n_sites=args.n_sites,
        in_pos=args.in_pos, in_pos_header=False,
        max_kb_dist=args.max_kb_dist, max_snp_dist=args.max_snp_dist,
        min_maf=args.min_maf, ignore_miss_data=args.ignore_miss_data,
        call_geno=args.call_geno, N_thresh=args.N_thresh, call_thresh=args.call_thresh,
        rnd_sample=args.rnd_sample, seed=args.seed, extend_out=args.extend_out,
        out=args.out, n_threads=args.n_threads, verbose=args.verbose,
        engine=args.engine, precision=args.precision, chunk_pairs=args.chunk_pairs,
        profile=args.profile, checkpoint=args.checkpoint, shard=args.shard,
        shard_ind=args.shard_ind, ring=args.ring, ring_sub=args.ring_sub,
    )
    if args.in_pos_header_file:
        pars.in_pos = args.in_pos_header_file
        pars.in_pos_header = True
    return pars.finalize()


def main(argv=None) -> int:
    try:
        pars = params_from_args(sys.argv[1:] if argv is None else argv)
    except ConfigError as e:
        sys.stderr.write(f"\n=====\nERROR: {e}\n=====\n\n")
        return 1
    try:
        if pars.engine == "strict":
            from . import strict
            strict.run(pars)
        else:
            from .engine import run_torch
            run_torch(pars)
    except StrictError as e:
        sys.stderr.write(f"\n=====\n{e}\n=====\n\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
