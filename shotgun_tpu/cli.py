"""Command-line interface: the reference's 4-task CLI on the JAX engine.

Tasks, flag grid, validation order, defaulting quirks and error strings
replicate the reference CLI exactly (reference main.py:26-406), including:

* truthiness-based task validation, so explicit ``0`` values slip through
  the per-task allowed-flag checks (reference main.py:321-334);
* ``-m 0`` / ``-p 0`` / ``--similarity-threshold 0`` silently coerced to
  the defaults 1 / 1 / 0.95 (reference main.py:337-342);
* ``--max-genomes 0`` honored (drops every k-mer that matches anything);
* ``--reverse-complement`` accepted but inert (dead flag in the reference,
  main.py:76);
* unreadable/unwritable-file messages, "Unsupported task." and
  "Error: Incorrect format of input file." verbatim.

One deliberate deviation: the reference crashes with a raw TypeError when
``align`` is given ``-g`` without ``-r`` (it tries to save the reference
to ``None``, main.py:366-372); we exit with a clean error instead.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
from typing import List, Optional

from shotgun_tpu.aligner import (
    AddingExistingRead,
    NotValidatingUniqueMapping,
    PseudoAlignment,
)
from shotgun_tpu.constants import (
    DEFAULT_AMBIGUOUS_THRESHOLD,
    DEFAULT_SIMILARITY_THRESHOLD,
    DEFAULT_UNIQUE_THRESHOLD,
)
from shotgun_tpu.errors import UserInputError
from shotgun_tpu.io.data_file import (
    FASTAFile,
    FASTAQFile,
    InvalidExtensionError,
    NoRecordsInDataFile,
    open_fastq_stream,
)
from shotgun_tpu.reference import KDBFormatError, KmerReference
from shotgun_tpu.utils.profiling import PROFILER, phase

# 0 = auto: aligner._auto_batch picks 32768 for big inputs (amortizes
# the per-batch table re-sort) and 2048 for small ones (small program,
# fast cold compile, warm executable already cached)
DEFAULT_BATCH_SIZE = 0


# ---------------------------------------------------------------------------
# file validation (reference main.py:30-54)
# ---------------------------------------------------------------------------

def validate_file_readable(filepath: str, description: str) -> None:
    if not os.path.isfile(filepath):
        sys.exit(f"Error: {description} file '{filepath}' does not exist or is not a file.")
    if not os.access(filepath, os.R_OK):
        sys.exit(f"Error: {description} file '{filepath}' is not readable.")


def validate_file_writable(filepath: str, description: str) -> None:
    dir_path = os.path.dirname(filepath) or "."
    if os.path.exists(filepath) and not os.access(filepath, os.W_OK):
        sys.exit(f"Error: {description} file '{filepath}' is not writable.")
    if not os.path.exists(filepath) and not os.access(dir_path, os.W_OK):
        sys.exit(
            f"Error: Directory '{dir_path}' is not writable to create "
            f"{description} file '{filepath}'."
        )


# ---------------------------------------------------------------------------
# argument parsing (reference main.py:61-82)
# ---------------------------------------------------------------------------

def parse_arguments(args: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="shotgun-tpu")
    parser.add_argument("-t", "--task", required=True, help="Task to execute")
    parser.add_argument("-g", "--genomefile", help="Genome FASTA file (multiple records)")
    parser.add_argument("-k", "--kmer-size", type=int, help="Length of k-mers")
    parser.add_argument("-r", "--referencefile", help="KDB file (input/output)")
    parser.add_argument("-a", "--alignfile",
                        help="aln file. Can be either input or name for output file")
    parser.add_argument("--reads", help="FASTQ reads file")
    parser.add_argument("-m", "--unique-threshold",
                        help="unique k-mer threshold", type=int)
    # the reference's long flag name carries a typo ("threhold"); kept
    # verbatim so the accepted flag surface matches exactly (main.py:70)
    parser.add_argument("-p", "--ambiguous-threhold",
                        dest="ambiguous_threhold",
                        help="ambiguous k-mer threshold", type=int)
    parser.add_argument("--reverse-complement", action="store_true")
    parser.add_argument("--min-read-quality", type=int, default=None)
    parser.add_argument("--min-kmer-quality", type=int, default=None)
    parser.add_argument("--max-genomes", type=int, default=None)
    parser.add_argument("--filter-similar", action="store_true")
    parser.add_argument("--similarity-threshold", type=float)
    parser.add_argument("--batch-size", type=int, default=DEFAULT_BATCH_SIZE,
                        help="device batch size, 0 = auto by input size "
                             "(tuning only; no effect on output)")
    parser.add_argument("--profile", action="store_true",
                        help="print per-phase timing/throughput to stderr")
    return parser.parse_args(args)


# ---------------------------------------------------------------------------
# orchestration helpers (reference main.py:89-310)
# ---------------------------------------------------------------------------

def create_reference(fasta_file: str, kmer_size: int,
                     filter_similar: bool = False,
                     similarity_threshold: float = 0.95) -> KmerReference:
    with phase("fasta_parse"):
        container = FASTAFile(fasta_file).container
    with phase("db_build"):
        return KmerReference(kmer_size, container,
                             filter_similar=filter_similar,
                             similarity_threshold=similarity_threshold)


def create_reference_and_save_it(fasta_file: str, kmer_size: int,
                                 reference_file: str,
                                 filter_similar: bool = False,
                                 similarity_threshold: float = 0.95) -> None:
    create_reference(
        fasta_file, kmer_size, filter_similar, similarity_threshold
    ).save(reference_file)


def dump_reference(kmer_reference: KmerReference) -> None:
    # streaming writer: byte-identical to json.dumps(get_summary(),
    # indent=4) but O(chunk) extra memory -- a 10M-k-mer dumpref streams
    # instead of materializing every k-mer string (reference kmer.py:300-329
    # holds the whole dict; see KmerReference.write_summary)
    kmer_reference.write_summary(sys.stdout)
    print()


def dump_reference_file(reference_file: str) -> None:
    try:
        kmer_reference = KmerReference.load(reference_file)
    except (KDBFormatError, gzip.BadGzipFile):
        sys.exit("Error: Incorrect format of input file.")
    dump_reference(kmer_reference)


def build_reference_and_dump_from_file(fasta_file: str, kmer_size: int,
                                       filter_similar: bool = False,
                                       similarity_threshold: float = 0.95) -> None:
    dump_reference(
        create_reference(fasta_file, kmer_size, filter_similar, similarity_threshold)
    )


def create_alignment_from_reference(
    kmer_reference: KmerReference, reads_file: str,
    m: int, p: int, min_read_quality: Optional[int],
    min_kmer_quality: Optional[int], max_genomes: Optional[int],
    batch_size: int = DEFAULT_BATCH_SIZE, store_reads: bool = True,
    mesh=None,
) -> PseudoAlignment:
    if mesh is not None:
        # device-mesh path (multi-chip and/or multi-process): reads are
        # the data-parallel axis, counters merge with exact integer
        # collectives, so the summary equals the single-device result
        with phase("fastq_parse"):
            batch = FASTAQFile(reads_file).container.to_read_batch()
        alignment = PseudoAlignment(kmer_reference)
        with phase("align", items=batch.num_reads):
            alignment.align_packed_reads(
                batch, m, p, min_read_quality, min_kmer_quality,
                max_genomes, batch_size=batch_size, store_reads=False,
                mesh=mesh,
            )
        return alignment
    # stream fast path for BOTH modes: chunks fill from the native
    # scanner with the validation overlapped (PP overlap); the align
    # task (store_reads=True) additionally collects packed per-read
    # store words and extracts ids in one native side pass.  None ->
    # file needs the regex engine (errors or non-ASCII).
    stream = open_fastq_stream(reads_file, lazy=True)
    if stream is not None:
        from shotgun_tpu.io.native import NativeParseError

        alignment = PseudoAlignment(kmer_reference)
        try:
            with phase("stream_align"):
                alignment.align_stream(
                    stream, m, p, min_read_quality, min_kmer_quality,
                    max_genomes, batch_size=batch_size,
                    store_reads=store_reads,
                )
            return alignment
        except NativeParseError:
            # invalid input discovered by the overlapped scan: redo on
            # the regex engine, which raises the reference's exact
            # error types and messages
            pass
    with phase("fastq_parse"):
        reads_container = FASTAQFile(reads_file).container
    alignment = PseudoAlignment(kmer_reference)
    with phase("align", items=reads_container.num_records):
        alignment.align_reads_from_container(
            reads_container, m, p, min_read_quality, min_kmer_quality,
            max_genomes, batch_size=batch_size, store_reads=store_reads,
        )
    return alignment


def create_alignment_file_from_reference(
    kmer_reference: KmerReference, reads_file: str, align_file: str,
    m: int, p: int, min_read_quality: Optional[int],
    min_kmer_quality: Optional[int], max_genomes: Optional[int],
    batch_size: int = DEFAULT_BATCH_SIZE,
) -> None:
    create_alignment_from_reference(
        kmer_reference, reads_file, m, p,
        min_read_quality, min_kmer_quality, max_genomes,
        batch_size=batch_size, store_reads=True,
    ).save(align_file)


def create_alignment_from_reference_file(
    reference_file: str, reads_file: str, align_file: str,
    m: int, p: int, min_read_quality: Optional[int],
    min_kmer_quality: Optional[int], max_genomes: Optional[int],
    batch_size: int = DEFAULT_BATCH_SIZE,
) -> None:
    try:
        kmer_reference = KmerReference.load(reference_file)
    except (KDBFormatError, gzip.BadGzipFile):
        sys.exit("Error: Incorrect format of input file.")
    create_alignment_file_from_reference(
        kmer_reference, reads_file, align_file, m, p,
        min_read_quality, min_kmer_quality, max_genomes, batch_size=batch_size,
    )


def dump_alignment_file(align_file: str) -> None:
    try:
        alignment = PseudoAlignment.load(align_file)
    except (KDBFormatError, gzip.BadGzipFile):
        sys.exit("Error: Incorrect format of input file.")
    print(json.dumps(alignment.get_summary(), indent=4))


def _print_alignment_summary(alignment: PseudoAlignment, mesh) -> None:
    """Under a multi-process mesh only host 0 writes the summary (every
    process computes the identical psum-merged result)."""
    if mesh is not None:
        from shotgun_tpu.parallel.distributed import is_primary

        if not is_primary():
            return
        # drain C-level stdio first: the CPU backend's Gloo transport
        # writes banners to the C stdout buffer, which otherwise flushes
        # at exit interleaved with Python's buffer, splitting the JSON
        try:
            import ctypes

            ctypes.CDLL(None).fflush(None)
        except Exception:
            pass
    print(json.dumps(alignment.get_summary(), indent=4), flush=True)


def dump_alignment_from_reference(
    reference_file: str, reads_file: str,
    m: int, p: int, min_read_quality: Optional[int],
    min_kmer_quality: Optional[int], max_genomes: Optional[int],
    batch_size: int = DEFAULT_BATCH_SIZE, mesh=None,
) -> None:
    try:
        kmer_reference = KmerReference.load(reference_file)
    except (KDBFormatError, gzip.BadGzipFile):
        sys.exit("Error: Incorrect format of input file.")
    alignment = create_alignment_from_reference(
        kmer_reference, reads_file, m, p,
        min_read_quality, min_kmer_quality, max_genomes,
        batch_size=batch_size, store_reads=False, mesh=mesh,
    )
    _print_alignment_summary(alignment, mesh)


def build_reference_align_and_dump(
    fasta_file: str, kmer_size: int, reads_file: str,
    m: int, p: int, min_read_quality: Optional[int],
    min_kmer_quality: Optional[int], max_genomes: Optional[int],
    filter_similar: bool = False, similarity_threshold: float = 0.95,
    batch_size: int = DEFAULT_BATCH_SIZE, mesh=None,
) -> None:
    kmer_reference = None
    container = None
    if (not filter_similar and mesh is None
            and os.environ.get("SHOTGUN_TPU_DEVICE_BUILD", "1") == "1"
            and os.environ.get("SHOTGUN_TPU_PROBE", "auto")
            in ("auto", "sort")):
        # device-side DB build (index/device_build.py): the probe table
        # assembles on the device with the align path's own sort machinery
        # and never materializes host postings -- dumpalign needs only
        # the summary.  None -> unsupported input (k > 31, > R_CAP
        # records, set caps); fall through to the host builder, whose
        # output is bit-identical (tests/test_device_build.py).
        with phase("fasta_parse"):
            container = FASTAFile(fasta_file).container
        from shotgun_tpu.index.device_build import (
            device_build_bytes,
            device_memory_budget,
        )
        from shotgun_tpu.io.packing import pack_genomes

        genomes = (container.to_genome_arrays()
                   if hasattr(container, "to_genome_arrays")
                   else pack_genomes(list(container)))
        # below MIN bases the native host build takes milliseconds, and
        # skipping the device build keeps a whole XLA program out of
        # the CLI run (cold compile and warm executable load both
        # drop); above the device-memory budget the build and the hash
        # table the auto probe assembles from it would not fit, and the
        # host build + host hash table serves that regime
        try:
            lo_gate = int(os.environ.get(
                "SHOTGUN_TPU_DEVICE_BUILD_MIN", 4_000_000))
        except ValueError:
            # malformed env value: fall back to the default rather than
            # crash the CLI (same convention as SHOTGUN_TPU_SUPERBATCH)
            lo_gate = 4_000_000
        budget = device_memory_budget()
        if lo_gate <= genomes.codes.size and (
                budget is None
                or device_build_bytes(genomes.codes.size,
                                      KmerReference._pad_rows) <= budget):
            with phase("db_build_device"):
                kmer_reference = KmerReference.from_device_build(
                    genomes, kmer_size)
    if kmer_reference is None:
        if container is not None:
            # reuse the parse from the device-build gate instead of
            # re-reading the FASTA from scratch
            with phase("db_build"):
                kmer_reference = KmerReference(
                    kmer_size, container,
                    filter_similar=filter_similar,
                    similarity_threshold=similarity_threshold)
        else:
            kmer_reference = create_reference(
                fasta_file, kmer_size, filter_similar, similarity_threshold
            )
    alignment = create_alignment_from_reference(
        kmer_reference, reads_file, m, p,
        min_read_quality, min_kmer_quality, max_genomes,
        batch_size=batch_size, store_reads=False, mesh=mesh,
    )
    _print_alignment_summary(alignment, mesh)


# ---------------------------------------------------------------------------
# entry point (reference main.py:317-402)
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> None:
    from shotgun_tpu.utils.platform import COMPILE_STATS, configure_platform

    configure_platform()  # also arms compile-stats when env-enabled
    args = parse_arguments(argv)
    if args.profile:
        PROFILER.enable()

    # Per-task flag-combination validation.  Deliberately truthiness-based:
    # explicit 0 values pass, as in the reference (main.py:321-334).
    if args.task == "reference":
        if (args.reads or args.alignfile or args.unique_threshold
                or args.ambiguous_threhold or args.min_read_quality
                or args.min_kmer_quality or args.max_genomes):
            sys.exit("Error: For task 'reference', only -g, -k, -r, "
                     "--filter-similar, and --similarity-threshold are allowed.")
    elif args.task == "dumpref":
        if (args.reads or args.alignfile or args.unique_threshold
                or args.ambiguous_threhold or args.min_read_quality
                or args.min_kmer_quality or args.max_genomes):
            sys.exit("Error: For task 'dumpref', only -r or (-g and -k) with "
                     "--filter-similar and --similarity-threshold are allowed.")
    elif args.task == "align":
        if not ((args.referencefile and args.reads and args.alignfile)
                or (args.genomefile and args.kmer_size and args.reads
                    and args.alignfile)):
            sys.exit("Error: For task 'align', provide either -r (reference file) "
                     "or -g and -k (genome file and kmer size) along with "
                     "--reads and -a.")
    elif args.task == "dumpalign":
        if not ((args.referencefile and args.reads)
                or (args.genomefile and args.kmer_size and args.reads)
                or args.alignfile):
            sys.exit("Error: For task 'dumpalign', provide either -r and --reads, "
                     "or -g, -k, and --reads, or -a.")
    else:
        sys.exit("Error: Unsupported task.")

    # Defaulting mirrors the reference's truthiness quirk (main.py:337-342):
    # explicit zeros are coerced to the defaults.
    if not args.unique_threshold:
        args.unique_threshold = DEFAULT_UNIQUE_THRESHOLD
    if not args.ambiguous_threhold:
        args.ambiguous_threhold = DEFAULT_AMBIGUOUS_THRESHOLD
    if not args.similarity_threshold:
        args.similarity_threshold = DEFAULT_SIMILARITY_THRESHOLD

    try:
        if args.task == "reference":
            validate_file_readable(args.genomefile, "Genome FASTA")
            validate_file_writable(args.referencefile, "Reference database output")
            create_reference_and_save_it(
                args.genomefile, args.kmer_size, args.referencefile,
                args.filter_similar, args.similarity_threshold,
            )
        elif args.task == "dumpref":
            if args.referencefile:
                validate_file_readable(args.referencefile, "Reference database")
                dump_reference_file(args.referencefile)
            elif args.genomefile and args.kmer_size:
                validate_file_readable(args.genomefile, "Genome FASTA")
                build_reference_and_dump_from_file(
                    args.genomefile, args.kmer_size,
                    args.filter_similar, args.similarity_threshold,
                )
        elif args.task == "align":
            validate_file_readable(args.reads, "FASTQ reads")
            validate_file_writable(args.alignfile, "Alignment output")
            if args.referencefile and args.reads and args.alignfile:
                validate_file_readable(args.referencefile, "Reference database")
                create_alignment_from_reference_file(
                    args.referencefile, args.reads, args.alignfile,
                    args.unique_threshold, args.ambiguous_threhold,
                    args.min_read_quality, args.min_kmer_quality,
                    args.max_genomes, batch_size=args.batch_size,
                )
            elif args.genomefile and args.kmer_size and args.reads and args.alignfile:
                validate_file_readable(args.genomefile, "Genome FASTA")
                if not args.referencefile:
                    # reference crashes here (save to None, main.py:372);
                    # we fail cleanly instead
                    sys.exit("Error: For task 'align' with -g, also provide -r "
                             "to store the reference database.")
                kmer_ref = create_reference(
                    args.genomefile, args.kmer_size,
                    args.filter_similar, args.similarity_threshold,
                )
                kmer_ref.save(args.referencefile)
                create_alignment_from_reference_file(
                    args.referencefile, args.reads, args.alignfile,
                    args.unique_threshold, args.ambiguous_threhold,
                    args.min_read_quality, args.min_kmer_quality,
                    args.max_genomes, batch_size=args.batch_size,
                )
        elif args.task == "dumpalign":
            # env-driven mesh wiring (SHOTGUN_TPU_NPROCS / SHOTGUN_TPU_MESH):
            # multi-chip and multi-host runs shard reads over the 'data'
            # axis and psum-merge -- output identical to single-device
            from shotgun_tpu.parallel.distributed import initialize_from_env

            mesh = initialize_from_env()
            if args.referencefile and args.reads:
                validate_file_readable(args.reads, "FASTQ reads")
                dump_alignment_from_reference(
                    args.referencefile, args.reads,
                    args.unique_threshold, args.ambiguous_threhold,
                    args.min_read_quality, args.min_kmer_quality,
                    args.max_genomes, batch_size=args.batch_size, mesh=mesh,
                )
            elif args.genomefile and args.kmer_size and args.reads:
                validate_file_readable(args.reads, "FASTQ reads")
                validate_file_readable(args.genomefile, "Genome FASTA")
                build_reference_align_and_dump(
                    args.genomefile, args.kmer_size, args.reads,
                    args.unique_threshold, args.ambiguous_threhold,
                    args.min_read_quality, args.min_kmer_quality,
                    args.max_genomes, args.filter_similar,
                    args.similarity_threshold, batch_size=args.batch_size,
                    mesh=mesh,
                )
            elif args.alignfile:
                validate_file_readable(args.alignfile, "Alignment output")
                dump_alignment_file(args.alignfile)
            else:
                sys.exit("Error: Provide either -g and -k with --reads, "
                         "or -r with --reads, or -a.")
        else:
            sys.exit("Error: Unsupported task.")
    except gzip.BadGzipFile:
        sys.exit("Error: Incorrect format of input file.")
    except (InvalidExtensionError, NoRecordsInDataFile,
            NotValidatingUniqueMapping, AddingExistingRead,
            UserInputError) as err:
        # the reference funnels bare ValueError here (main.py:401) because
        # its engine raises plain ValueError for user-input problems; we
        # catch only the UserInputError subclass those sites raise, so an
        # unexpected internal ValueError tracebacks instead of being
        # silently presented as a clean user error
        sys.exit(err)
    finally:
        PROFILER.report()
        if COMPILE_STATS:
            # one machine-readable stderr line so the bench warm-compile
            # probe can attribute wall time to XLA compilation exactly
            print("SHOTGUN_TPU_COMPILE_STATS " + json.dumps(COMPILE_STATS),
                  file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
