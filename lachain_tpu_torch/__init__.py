"""lachain_tpu_torch: the PyTorch/CUDA port of lachain_tpu's device crypto.

Two era paths run on the card through `crypto.gpu_backend.GpuBackend`:
  * the TPKE era verify+combine (`tpke_era_verify_combine`): the BLS12-381
    G1 kernels of csrc/g1.cu, bound in ops/g1.py, under GpuEraPipeline;
  * the common coin (`crypto.threshold_sig.era_verify_combine` over
    `ts_era_verify_combine`): the G2 kernels of csrc/g2.cu, bound in
    ops/g2.py, under TsGpuEraPipeline, with the key aggregate on the G1
    kernels.
`GpuBackend.g1_msm` / `g2_msm` run single MSMs on the same kernels.
Pool-ingest ECDSA recovery runs `crypto.ecdsa.recover_hash_batch` over
`ops.secp.GpuEcdsaRecover` and the secp256k1 kernels of csrc/secp.cu. An
era's reliable-broadcast flush runs `consensus.rbc_batcher.RbcEraBatcher`
over `ops.rs_batch` and the Reed-Solomon kernel of csrc/rs.cu. The
consensus (`consensus/`) runs an era from the proposals to its block
(`consensus.root_protocol.RootProtocol`), whose senders
`core.types.warm_sender_caches` recovers on the same secp256k1 kernels;
its host ECDSA runs in the native host library (`crypto.ecdsa`). A
validator's trustless keygen (`consensus.keygen.TrustlessKeygen`) runs its
commitment checks as G1 MSMs on the same G1 kernels
(`GpuBackend.g1_msm_batch`, `g1_msm`). The
package imports torch and numpy and nothing of JAX or of lachain_tpu. Its
entry points run on the card unless the caller passes device="cpu".
"""
