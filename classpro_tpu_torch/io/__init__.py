"""File-format codecs (host data plane).

FASTK formats (ref libfastk.c), FASTA/FASTQ (ref kseq.h usage in
ClassPro.h:49), the fastq-like ``.class`` output (ref ClassPro.c:289),
DAZZ_DB databases and tracks (``dazz``, ref DB.h/DB.c) and the read-order
merge of shard files (``merge``, ref io.c:15-112).
"""

from classpro_tpu_torch.io.fastk import (  # noqa: F401
    Histogram,
    ProfileIndex,
    decode_profile,
    encode_profile,
    load_histogram,
    open_profiles,
    write_histogram,
    write_profiles,
)
from classpro_tpu_torch.io.fastx import read_fastx, write_fasta  # noqa: F401
from classpro_tpu_torch.io.classfile import read_class, write_class  # noqa: F401
