"""Genome index of the port: kart_tpu's framework-free index layer (FASTA
parsing, BWT and suffix-array build, on-disk format, loader), used as it is
under the port's module name."""

from kart_tpu.index import GenomeIndex, build_index, index_files_exist, load_index

__all__ = ["GenomeIndex", "build_index", "index_files_exist", "load_index"]
