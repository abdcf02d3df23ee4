from edl_tpu_torch.rpc.wire import FrameReader, pack_frame, unpack_payload

__all__ = ["FrameReader", "pack_frame", "unpack_payload"]
