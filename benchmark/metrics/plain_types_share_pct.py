"""plain_types_share_pct: the share of an ``apply_all_transformations``
call taken by its four plain-PyTorch types (translation, gaussian noise,
contrast, lighten / darken), each with its draw: the stream time of the
port's ``apply_all.<type>`` spans of those types over that of their
``apply_all.call`` spans, over the traced stretch. None without the port's
spans."""

from harness import spans

PLAIN = ("apply_all.translation", "apply_all.gaussian_noise", "apply_all.contrast",
         "apply_all.lighten_darken")


def read(ctx):
    return spans.stream_share_pct(PLAIN, "apply_all.call")
