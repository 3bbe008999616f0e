"""classpro_tpu_torch — the PyTorch/CUDA port of classpro_tpu.

Same classification (Error / Haploid / Diplo / Repeat per k-mer of every
HiFi read, from FASTK count profiles), with the reliable-interval DP
(``csrc/rel_dp.cu``) and the relaxation sweeps (``csrc/unrel.cu``) as
hand-written CUDA kernels for Hopper.  The package
imports torch, numpy and scipy and nothing of ``classpro_tpu``; the
numpy-only modules it needs are its own copies.

Layout
------
- ``device``     : device selection (CUDA unless the caller asks for CPU)
- ``io``, ``estimation``, ``numerics``, ``constants``, ``tables``,
  ``native``     : host data plane (copies; C++ via csrc/classpro_host.cpp)
- ``skellam``    : log-Skellam interpolation tables + the plain torch lookup
- ``params``     : device-resident parameters (``RelParams``,
  ``UnrelParams``, ``PipelineParams``)
- ``rel_ref``    : plain torch reliable-interval DP (the kernel's yardstick)
- ``unrel_ref``  : plain torch relaxation sweeps (the kernel's yardstick)
- ``kernels``    : nvcc/g++ builds and the ctypes wrappers of the kernels
- ``rel``        : per-chunk glue around the DP (``rel_only``) + host steps
- ``pack``       : the all-device path's blob packing and class expansion
- ``alldev``     : ``classify_batch``, the all-device program of a chunk
- ``engine``     : ``TorchEngine`` streaming classifier (``alldev=True``
  takes the all-device path, ``devices=[...]`` round-robins chunks)
- ``parallel``   : ``mesh`` (the histogram all-reduce, K8, and
  ``sharded_classify``) and ``driver`` (the multi-process shard driver)
- ``cli``        : ``python -m classpro_tpu_torch.cli classify`` (FASTX or
  DAZZ input, ``-s`` seeds)
"""

__version__ = "0.1.0"
