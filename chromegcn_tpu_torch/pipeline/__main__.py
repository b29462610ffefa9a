"""Pipeline CLI: build dataset + Hi-C graph artifacts from raw inputs (port of
chromegcn_tpu/pipeline/__main__.py, the same flags and files).

Replaces `python create_data.py --run_file {1..7}` + `create_torch_data.py`
(reference: data/create_data.py:14, data/create_torch_data.py:120) with one
command:

    python -m chromegcn_tpu_torch.pipeline \
        --fasta hg19.fa --peaks peaks/GM12878 --hic hic/GM12878 \
        --out processed_data/GM12878/1000 \
        --hicsize 500000 --hicnorm SQRTVC
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fasta", required=True, help="genome FASTA (e.g. hg19.fa)")
    p.add_argument("--peaks", required=True, help="directory of narrowPeak files")
    p.add_argument("--hic", default=None, help="directory of {chrom}.RAWobserved dumps")
    p.add_argument("--out", required=True, help="output dataset directory")
    p.add_argument("--window", type=int, default=1000)
    p.add_argument("--extended", type=int, default=2000)
    p.add_argument("--min-frac", type=float, default=0.1)
    p.add_argument("--small", type=int, default=0,
                   help="also write dataset_small.npz with N windows per split")
    p.add_argument("--hicsize", type=int, default=500_000)
    p.add_argument("--hicnorm", default="SQRTVC", choices=["KR", "VC", "SQRTVC", ""])
    p.add_argument("--resolution", type=int, default=1000, help="Hi-C bin size (bp)")
    p.add_argument("--upsample-5kb", action="store_true",
                   help="replicate 5kb Hi-C contacts onto the 1kb grid (K562 flow)")
    p.add_argument("--min-dist", type=int, default=0,
                   help="genomic-distance floor (bp) applied before top-k "
                        "(old graph builder's min_distance_threshold)")
    p.add_argument("--max-dist", type=int, default=None,
                   help="genomic-distance ceiling (bp), pre-top-k (extension)")
    args = p.parse_args(argv)

    from chromegcn_tpu_torch.pipeline.build import build_dataset, build_hic_graphs

    splits = build_dataset(
        args.fasta, args.peaks, args.out,
        window=args.window, extended=args.extended, min_frac=args.min_frac,
        small_per_split=args.small,
    )
    if args.hic:
        build_hic_graphs(
            splits, args.hic, args.out,
            hicsize=args.hicsize, hicnorm=args.hicnorm,
            resolution_bp=args.resolution, upsample_5kb=args.upsample_5kb,
            min_dist_bp=args.min_dist, max_dist_bp=args.max_dist,
        )


if __name__ == "__main__":
    main()
