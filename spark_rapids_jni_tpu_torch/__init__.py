"""spark_rapids_jni_tpu_torch: the PyTorch/CUDA port of spark_rapids_jni_tpu.

The same Spark-exact columnar kernels, written for one NVIDIA H100 with
PyTorch for the plain tensor code and hand-written CUDA C++ (``csrc/``) for
the kernels the JAX package wrote in Pallas:

  * columnar/  - dtypes, Column/Table over torch tensors, the wire-format
                 interop with the JAX package, gather/slice/filter.
  * ops/       - Spark row hashes (murmur3_32, xxhash64), JCUDF row
                 conversion, sort, sort-probe joins, sorted groupby, the
                 plan cores the fused engine composes, and ops/kernels.py:
                 the CUDA kernel wrappers, their plain PyTorch versions and
                 launch counters.
  * parallel/  - the shuffle partition route (murmur3 mod partitions).
  * plan/      - the plan engine: plan IR, eager interpreter, cost-shaped
                 planner, and the fused executor (one program of torch ops
                 per query, one host sync); its knobs are utils/config.py.
  * tpch.py    - TPC-H q1, q3, q5 and q6: tables and both engines.
  * csrc/      - CUDA sources, built with nvcc for sm_90a at first use
                 into build/torch_kernels/.

Entry points put their tensors on the card unless the caller passes
``device="cpu"``. Every op runs on the device of its input tensors; a
kernel wrapper launches its CUDA kernel for a CUDA tensor and takes the
plain PyTorch version only for a CPU tensor.

The package imports torch, numpy and the standard library only — never
jax and nothing of spark_rapids_jni_tpu.
"""
