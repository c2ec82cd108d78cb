"""kart-tpu-torch command line, with the flag surface of kart_tpu's CLI.

  python -m kart_tpu_torch.cli index ref.fa prefix
  python -m kart_tpu_torch.cli -i prefix -f r1 [...] [-f2 r2 [...]]
         [-o out.sam | -bo out.bam] [-backend native|python] [-cpu]
         [-t N] [-g N] [-m] [-p] [-silent] [-d]

The default native backend maps with the host C++ engine (native/kart_post.cpp); with
KART_SEED_MODE=device it seeds, resolves and packs on the device through
the port's kernels and maps the downloaded stream with the C++ engine (the
device-pipelined mode).  `-backend python` runs the python pipeline around
device seeding and device NW.  Device work runs on the CUDA device; `-cpu`
selects the CPU and the kernels' plain versions instead, and without `-cpu`
and without a CUDA device a mode that needs the device fails.  `-pacbio` and
`-idx-shards` raise NotImplementedError.
"""

from __future__ import annotations

import os
import sys
import time

VERSION = "2.5.6"  # the reference CLI's parity version (SAM @PG VN), as kart_tpu


def usage(prog: str) -> None:
    print(f"kart-tpu-torch v{VERSION} (PyTorch/CUDA port of kart-tpu)\n")
    print(
        f"Usage: {prog} -i Index_Prefix -f <ReadFile_A1 ReadFile_B1 ...>"
        " [-f2 <ReadFile_A2 ReadFile_B2 ...>] -o Output\n"
    )
    print("Options: -t INT        number of threads of the native engine [4]")
    print("         -f            files with #1 mates reads (format:fa, fq, fq.gz)")
    print("         -f2           files with #2 mates reads (format:fa, fq, fq.gz)")
    print("         -o            alignment filename in SAM format [output.sam]")
    print("         -bo           alignment filename in BAM format")
    print("         -m            output multiple alignments")
    print("         -g INT        max gaps (indels) [5]")
    print("         -p            paired-end reads are interlaced in the same file")
    print("         -pacbio       pacbio data (not ported yet)")
    print("         -cpu          run on the CPU with the kernels' plain versions")
    print("         -backend B    native (C++ engine, default) or python")
    print("         -idx-shards N shard the FM-index over N devices (not ported yet)")
    print("         -v            version\n")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "kart-tpu-torch"
    args = argv[1:]

    if not args or args[0] == "-h":
        usage(prog)
        return 0
    if args[0] == "index":
        if len(args) == 3:
            from .index import build_index

            build_index(args[1], args[2])
            return 0
        print(f"usage: {prog} index ref.fa prefix", file=sys.stderr)
        return 1

    max_gaps = 5
    pair_end = False
    pacbio = False
    multi_hit = False
    silent = False
    debug = False
    threads = 4
    device = "cuda"
    backend = "native"
    idx_shards = int(os.environ.get("KART_IDX_SHARDS", "0"))
    out_name = "output.sam"
    out_format = 0
    index_name = None
    files1: list[str] = []
    files2: list[str] = []

    i = 0
    while i < len(args):
        p = args[i]
        if p == "-i":
            i += 1
            index_name = args[i]
        elif p == "-f":
            while i + 1 < len(args) and not args[i + 1].startswith("-"):
                i += 1
                files1.append(args[i])
        elif p == "-f2":
            while i + 1 < len(args) and not args[i + 1].startswith("-"):
                i += 1
                files2.append(args[i])
        elif p == "-t" and i + 1 < len(args):
            i += 1
            threads = int(args[i])
            if threads <= 0:
                print("Warning! Thread number should be a positive number!")
                threads = 4
        elif p == "-g":
            i += 1
            max_gaps = max(0, int(args[i]))
        elif p == "-o":
            i += 1
            out_format = 0
            out_name = args[i]
        elif p == "-bo":
            i += 1
            out_format = 1
            out_name = args[i]
        elif p == "-silent":
            silent = True
        elif p == "-pacbio":
            pacbio = True
        elif p == "-m":
            multi_hit = True
        elif p in ("-p", "-pair"):
            pair_end = True
        elif p in ("-d", "-debug"):
            debug = True
        elif p == "-cpu":
            device = "cpu"
        elif p == "-idx-shards" and i + 1 < len(args):
            i += 1
            idx_shards = int(args[i])
        elif p == "-backend" and i + 1 < len(args):
            i += 1
            backend = args[i]
        elif p in ("-v", "--version"):
            print(f"kart-tpu-torch v{VERSION}\n")
            return 0
        else:
            print(f"Error! Unknown parameter: {p}")
            usage(prog)
            return 1
        i += 1

    if backend not in ("native", "python"):
        print(f"Error! Unknown backend: {backend} (the port has: native, python)")
        return 1
    if idx_shards > 1:
        raise NotImplementedError("-idx-shards is not ported yet (ROADMAP Queue 1 item 10)")
    if not files1:
        print("Error! Please specify a valid read input!")
        usage(prog)
        return 1
    if files2 and len(files1) != len(files2):
        print("Error! Paired-end reads input numbers do not match!")
        return 1
    for f in files1 + files2:
        if not os.path.exists(f):
            print(f"Cannot access file:[{f}]")
            return 0
    if index_name is None:
        print("Error! Please specify a valid reference index!")
        usage(prog)
        return 1

    import torch

    seed_mode = os.environ.get("KART_SEED_MODE", "native")
    uses_device = backend == "python" or seed_mode == "device"
    if uses_device and device == "cuda" and not torch.cuda.is_available():
        print(
            "Error! No CUDA device is available; pass -cpu to map on the CPU "
            "with the kernels' plain versions.",
            file=sys.stderr,
        )
        return 1

    from .index import index_files_exist, load_index

    if not index_files_exist(index_name):
        print("Error! Please specify a valid reference index!")
        return 1

    t_setup = time.time()
    print("Load the genome index files...")
    gidx = load_index(index_name)
    print("Load the reference sequences...")

    from .io.fastq import check_read_format
    from .ops.nw import nw_stats
    from .pipeline.mapper import TorchKartMapper
    from .pipeline.sam import sam_header

    if debug:
        threads = 1  # reference: debug mode forces one thread (Mapping.cpp:648)
    mapper = TorchKartMapper(
        gidx, device=device, pacbio=pacbio, max_gaps=max_gaps, multi_hit=multi_hit,
        backend=backend, n_threads=threads, debug=debug,
    )

    if out_format == 0:
        out_f = open(out_name, "wb")

        def writer(s):
            out_f.write(s if isinstance(s, bytes) else s.encode("ascii"))

        closer = out_f.close
    else:
        from .io.bam import BamWriter

        bw = BamWriter(out_name, gidx, version=VERSION)

        def writer(s):
            bw.write_sam_text(s.decode("ascii") if isinstance(s, bytes) else s)

        closer = bw.close

    mapper.prepare()
    t_setup = time.time() - t_setup
    nw_before = dict(nw_stats)
    t0 = time.time()
    try:
        writer(sam_header(gidx, VERSION))
        sep_library = len(files2) == len(files1) and len(files2) > 0
        for lib in range(len(files1)):
            fastq = check_read_format(files1[lib])
            path2 = None
            lib_pair = pair_end
            if sep_library:
                lib_pair = True
                if fastq != check_read_format(files2[lib]):
                    print(f"Error! {files1[lib]} and {files2[lib]} are with different format...")
                    continue
                path2 = files2[lib]

            progress = None
            if not silent:
                kind = "paired-end" if lib_pair else "singled-end"

                def progress(total, kind=kind):
                    print(
                        f"\r{total} {kind} reads have been processed"
                        f" in {int(time.time() - t0)} seconds...",
                        end="",
                        flush=True,
                    )

            mapper.map_stream(files1[lib], path2, lib_pair, fastq, writer, progress)
    finally:
        closer()

    t_map = time.time() - t0
    st = mapper.stats
    total = st["total"]
    print(
        f"\rAll the {total} {'paired-end' if (pair_end or sep_library) else 'single-end'} reads"
        f" have been processed in {int(time.time() - t0)} seconds."
    )
    if total > 0:
        mapped = total - st["unmapped"]
        sens = int(10000 * (mapped / total) + 0.5) / 100.0
        if pair_end or sep_library:
            pct = int(10000 * (st["paired"] / total) + 0.5) / 100.0
            avg = st["distance"] // (st["paired"] >> 1) if st["paired"] > 1 else 0
            print(
                f"\t# of total mapped sequences = {mapped} (sensitivity = {sens:.2f}%)\n"
                f"\t# of paired sequences = {st['paired']} ({pct:.2f}%), average insert size = {avg}"
            )
        else:
            print(f"\t# of total mapped sequences = {mapped} (sensitivity = {sens:.2f}%)")
        if backend == "python":
            print(
                f"\t# of NW fragments on {device} = {nw_stats['device'] - nw_before['device']},"
                f" on the host = {nw_stats['host'] - nw_before['host']},"
                f" memo misses = {mapper.conquer.nw_memo_misses}"
            )
        elif seed_mode == "device":
            log = mapper.group_log
            print(
                f"\t# of device seeding groups on {device} = {len(log)},"
                f" flagged lanes = {sum(g['flagged'] for g in log)},"
                f" re-seeded on the device = {sum(g['reseeded_device'] for g in log)},"
                f" on the host = {sum(g['reseeded_host'] for g in log)}\n"
                f"\t  per group: reads {[g['reads'] for g in log]},"
                f" flagged {[g['flagged'] for g in log]},"
                f" re-seeded on the host {[g['reseeded_host'] for g in log]}"
            )
        print(f"\tset-up {t_setup:.3f} s (index, tables, device arrays), mapping {t_map:.3f} s")
        print(f"Alignment output: {out_name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
