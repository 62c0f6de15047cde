"""RankGraph-2 in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` (which stays the reference).  This
package imports ``torch`` and ``numpy`` only; it shares no module with
``repro``.  Layout mirrors ``repro`` so each counterpart is found by
path.  Covered so far: the publish-and-serve slice — full-corpus
embedding (``core.trainer.embed_all``), RQ corpus encode with the
``rq_assign`` kernel, snapshot building (``lifecycle.publish``) and the
cluster-queue serving store with the ``queue_gather`` kernel
(``core.serving``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises.
"""
