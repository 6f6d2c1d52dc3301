"""One launch of the framed one-hot render (``kernels/render.cu``'s
``render_onehot_framed_kernel``, ``ops.render.render_framed_onehot_batched``)
over ``batch`` states of ``objects`` movables into frames of ``frame_h`` x
``frame_w`` cells.

Written, a state: its frame's 6 float32 channels a cell (24 bytes a cell,
the pad's too).  Read, a state: its positions (8 bytes a movable) and its
puzzle index (4 bytes).  Read once: the stacked render tables
(``table_bytes``)."""


def framed_bytes_per_launch(batch: int, frame_h: int, frame_w: int, objects: int, table_bytes: int = 0) -> int:
    return batch * (24 * frame_h * frame_w + 8 * objects + 4) + table_bytes
