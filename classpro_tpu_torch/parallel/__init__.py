"""Data parallelism over devices and processes (the JAX package's
``classpro_tpu.parallel``).

There is no model state to shard: parallelism is over reads (the
reference's pthread block partition, ClassPro.c:574-578), with every
table replicated.  ``mesh`` holds the one collective (``psum_histogram``,
a ``torch.distributed`` all-reduce) and ``sharded_classify`` (one read
shard per device); ``driver`` is the multi-process shard driver with
resume and merge.
"""

from classpro_tpu_torch.parallel.mesh import (  # noqa: F401
    psum_histogram,
    sharded_classify,
)
