"""roofline.ag: roofline.serve's reading, in the gated net's cell (its
call's least time counts the gates' layers, reference/attn_unet.py)."""

import harness

read = harness.metric_reader("roofline.serve")
