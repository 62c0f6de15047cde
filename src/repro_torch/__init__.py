"""RankGraph-2 in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` (which stays the reference).  This
package imports ``torch`` and ``numpy`` only; it shares no module with
``repro``.  Layout mirrors ``repro`` so each counterpart is found by
path.  Covered so far, slice by slice:

  * publish-and-serve: full-corpus embedding (``core.trainer.
    embed_all``), RQ corpus encode with the ``rq_assign`` kernel,
    snapshot building (``lifecycle.publish``) and the cluster-queue
    serving store with the ``queue_gather`` kernel (``core.serving``);
  * construct-and-train: ``core.pipeline.run_pipeline`` (graph build,
    PPR tables with the ``ppr_walk`` kernel, train steps whose
    contrastive losses run the ``fused_contrastive`` kernels);
  * recsys serve-and-train: ``models.recsys.models`` and the recsys
    steps of ``launch.steps``, multi-hot bags on the ``embedding_bag``
    kernels;
  * dense LM serving: ``models.lm.model`` (olmo-1b, llama3.2-3b,
    gemma-2b prefill and KV-cache decode) and the LM steps of
    ``launch.steps``, attention on the ``flash_attention`` kernel.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises.
"""
