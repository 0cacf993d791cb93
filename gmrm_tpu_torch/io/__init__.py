"""File I/O of the port: its own copies of gmrm_tpu/io: PLINK .bed/.phen/.bim
readers, the .dim/.gri/.grm readers, the .bet/.cpn/.csv writers and the
dataset simulator.  ``read_bed`` (without ``use_mmap``) and ``read_phen``
(given the expected count) read through the port's host C++ library
(``io/native.py``, built from ``csrc/io_native.cpp`` at first use); their
NumPy routes (``route="numpy"``) are the plain versions the tests hold it
against."""

from gmrm_tpu_torch.io.bed import read_bed, write_bed, bed_bytes_per_marker
from gmrm_tpu_torch.io.phen import Phenotype, read_phen
from gmrm_tpu_torch.io.grouping import read_dim, read_group_index, read_group_mixtures
from gmrm_tpu_torch.io.bim import read_bim_ids
from gmrm_tpu_torch.io.writers import (
    HistoryWriter,
    read_history,
    write_csv_record,
    format_csv_record,
    format_mlma_line,
)
