"""window_attention_share_pct: the share of a sweep cell taken by the
Swin blocks' attention halves (LayerNorm, the shift and window partition,
qkv, the attention products, bias, mask and softmax, proj, the reverse
and the residual add): the stream time of the port's ``swin.attention``
spans over that of their ``sweep.cell`` spans, over the traced stretch.
None without those spans (another network, a CPU run, a port without
Swin)."""

from harness import spans


def read(ctx):
    return spans.stream_share_pct(("swin.attention",), "sweep.cell")
