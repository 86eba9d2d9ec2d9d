"""``praline-tpu-torch`` command line: the alignment knobs of ``praline-tpu``
plus ``--device``.

Usage:  praline-tpu-torch input.fasta output.aln [options]
        python -m praline_tpu_torch.cli input.fasta output.aln [options]

The default device is ``cuda``; without a card the run fails unless
``--device cpu`` is given.  ``--profile-dir DIR`` writes a
``torch.profiler`` trace of the run there (``util/metrics.py``), unless a
torch profiler is already recording: the program's spans
(``<layer>:<step>``) record under any such profiler, and the run then
writes no file of its own.  ``METRICS.counters`` holds the DP cells each
route launched and needed, and the device merge's, over the process;
``--score-against REF`` prints the SP/TC column accuracy of the result
against a reference alignment.  ``--devices N`` shards the pair space
over the first N cards (``config.mesh_shape``, ``dist/mesh.py``);
``--blast-db DB`` extends the preprofiles with the PSI-BLAST hits of each
sequence in DB (``msa/homology.py``; ``psiblast`` must be on PATH).  The
JAX build's backends (``--backend xla|pallas``) are accepted by the parser
and refused with a message.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

NOT_PORTED = "is not ported to praline-tpu-torch yet (see ROADMAP.md); use praline-tpu"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="praline-tpu-torch",
        description="Progressive multiple sequence alignment on PyTorch/CUDA "
        "(the port of praline-tpu).",
    )
    p.add_argument("input", help="input FASTA file (ungapped sequences)")
    p.add_argument("output", help="output alignment file")
    p.add_argument("-m", "--matrix", default="blosum62",
                   help="builtin matrix name (blosum45/50/62/80, pam30/70/120/250, "
                   "dna_simple) or a matrix file path")
    p.add_argument("-a", "--alphabet", choices=["protein", "dna"], default="protein")
    p.add_argument("-g", "--gap-series", default="11,1", metavar="G1,G2,...",
                   help="gap penalty series: the m-th consecutive gap column costs "
                   "G[min(m,k)] (default 11,1 = affine open 11 / extend 1)")
    p.add_argument("--mode", choices=["global", "semiglobal", "local"], default="global",
                   help="alignment mode for merges and the distance stage")
    p.add_argument("--distance-mode", choices=["global", "semiglobal", "local"],
                   default=None, help="override mode for the all-pairs distance stage")
    p.add_argument("-p", "--preprofile", choices=["none", "global", "local"],
                   default="none", help="master-slave preprofile strategy")
    p.add_argument("--preprofile-gap-series", default=None, metavar="G1,G2,...",
                   help="gap series for preprofile alignments (default: --gap-series)")
    p.add_argument("--blast-db", default=None, metavar="DB",
                   help="PSI-BLAST database for homology-extended preprofiles "
                   "(requires psiblast on PATH)")
    p.add_argument("--linkage", choices=["single", "complete", "average"], default="average")
    p.add_argument("--score-normalization", choices=["none", "length"], default="length",
                   help="normalize pairwise scores by alignment length for the guide tree")
    p.add_argument("-f", "--format", choices=["fasta", "clustal"], default=None,
                   help="output format (default: by output extension, else fasta)")
    p.add_argument("--tree-out", default=None, metavar="FILE",
                   help="also write the guide tree as Newick")
    p.add_argument("--score-against", default=None, metavar="REF",
                   help="report SP/TC column-accuracy of the result against a reference "
                   "alignment (FASTA or CLUSTAL by extension); metric only")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="compute device (default cuda; cpu runs the plain PyTorch path)")
    p.add_argument("--backend", choices=["auto", "oracle", "xla", "pallas"], default="auto",
                   help="auto = the PyTorch port, oracle = the NumPy reference")
    p.add_argument("--batch-pairs", type=int, default=512, metavar="N",
                   help="pairwise DP problems per batched merge dispatch")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="write resumable stage checkpoints here")
    p.add_argument("--resume", default=None, metavar="DIR",
                   help="resume from a checkpoint dir (same as --checkpoint-dir)")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="shard the pair space over the first N devices")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace (Chrome format) of the run here")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v: stage progress, -vv: debug")
    p.add_argument("--log-json", action="store_true", help="emit log lines as JSON")
    return p


def parse_gap_series(text: str) -> tuple[int, ...]:
    try:
        series = tuple(int(x) for x in text.replace(" ", "").split(",") if x)
    except ValueError:
        raise SystemExit(f"error: invalid gap series {text!r} (expected e.g. '11,1')")
    if not series or any(g < 0 for g in series):
        raise SystemExit(f"error: invalid gap series {text!r} (need non-negative costs)")
    return series


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.backend in ("xla", "pallas"):
        print(f"error: --backend {args.backend} {NOT_PORTED}", file=sys.stderr)
        return 2

    from ..util.metrics import configure_logging, disable_profiling, enable_profiling

    configure_logging(args.verbose, json_lines=args.log_json)
    if args.profile_dir:
        enable_profiling(args.profile_dir)
    try:
        return _run(args)
    finally:
        disable_profiling()


def _run(args) -> int:
    """The run of :func:`main` past the knob checks (profiling armed)."""
    from .. import io as pio
    from ..types import ALPHABETS, PralineConfig
    from ..util.metrics import METRICS, log

    alphabet_name = "dna" if args.alphabet == "dna" else "protein"
    alphabet = ALPHABETS[alphabet_name]
    try:
        matrix = pio.resolve_score_matrix(args.matrix, alphabet)
        sequences = pio.load_sequence_fasta(args.input, alphabet)
    except (KeyError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    log.info("loaded %d sequences from %s", len(sequences), args.input)

    out_format = args.format or (
        "clustal" if args.output.endswith((".aln", ".clustal", ".clu")) else "fasta"
    )
    config = PralineConfig(
        score_matrix=args.matrix,
        alphabet=alphabet_name,
        gap_series=parse_gap_series(args.gap_series),
        merge_mode=args.mode,
        distance_mode=args.distance_mode or args.mode,
        preprofile_mode="dummy" if args.preprofile == "none" else args.preprofile,
        preprofile_gap_series=(
            parse_gap_series(args.preprofile_gap_series) if args.preprofile_gap_series else None
        ),
        linkage=args.linkage,
        score_normalization=args.score_normalization,
        output_format=out_format,
        batch_pairs=args.batch_pairs,
        backend=args.backend,
        checkpoint_dir=args.checkpoint_dir or args.resume,
        mesh_shape=(args.devices,) if args.devices else None,
    )

    on_tree = None
    if args.tree_out:
        try:  # fail on an unwritable path before the expensive stages
            Path(args.tree_out).touch()
        except OSError as e:
            print(f"error: --tree-out: {e}", file=sys.stderr)
            return 2

        def on_tree(tree, _path=args.tree_out):
            Path(_path).write_text(tree.newick([s.name for s in sequences]) + "\n")

    from ..device import resolve_device
    from ..dist import make_pair_mesh
    from ..msa import msa_align

    device = "cpu"  # the oracle backend is NumPy and needs no device
    if args.backend != "oracle":
        try:
            device = resolve_device(args.device)
            if args.devices:  # fail on too few devices before the expensive stages
                make_pair_mesh(args.devices, device=device.type)
        except (RuntimeError, ValueError) as e:  # no card for --device cuda, too few
            print(f"error: {e}", file=sys.stderr)
            return 2

    extra_slaves = None
    if args.blast_db:
        from ..msa import find_homologs_blast

        try:
            with METRICS.timed("blast"):
                extra_slaves = find_homologs_blast(sequences, args.blast_db)
        except FileNotFoundError as e:  # no psiblast on PATH
            print(f"error: --blast-db: {e}", file=sys.stderr)
            return 2
        log.info("blast: hits for %d of %d sequences", len(extra_slaves), len(sequences))

    # --devices is recorded as config.mesh_shape; msa_align builds the mesh.
    t0 = time.perf_counter()
    alignment = msa_align(sequences, matrix, config, device=device, extra_slaves=extra_slaves,
                          on_tree=on_tree)
    log.info("aligned %d sequences into %d columns in %.2fs",
             alignment.num_members, alignment.num_columns, time.perf_counter() - t0)
    if out_format == "clustal":
        pio.write_alignment_clustal(alignment, args.output)
    else:
        pio.write_alignment_fasta(alignment, args.output, wrap=config.fasta_wrap)

    if args.score_against:
        from ..util.accuracy import sp_tc

        ref_path = args.score_against
        try:
            if ref_path.endswith((".aln", ".clustal", ".clu")):
                ref = pio.load_alignment_clustal(ref_path, alphabet)
            else:
                ref = pio.load_alignment_fasta(ref_path, alphabet)
            sp, tc = sp_tc(alignment, ref)
        except (OSError, ValueError) as e:
            print(f"error: --score-against: {e}", file=sys.stderr)
            return 2
        log.info("column accuracy vs %s: SP=%.4f TC=%.4f", ref_path, sp, tc)
        print(f"SP={sp:.4f} TC={tc:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
