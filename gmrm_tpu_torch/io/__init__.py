"""File I/O of the port: its own copies of gmrm_tpu/io (NumPy only): PLINK
.bed/.phen/.bim readers, the .dim/.gri/.grm readers, the .bet/.cpn/.csv
writers and the dataset simulator.  The optional native reader of the JAX
package (gmrm_tpu/io/native.py) is not ported; these take the NumPy
routes."""

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
