from .builder import build_index
from .format import index_files_exist, load_raw_index
from .loader import GenomeIndex, load_index

__all__ = ["build_index", "index_files_exist", "load_raw_index", "GenomeIndex", "load_index"]
