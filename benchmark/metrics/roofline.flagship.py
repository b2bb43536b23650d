"""roofline.flagship: roofline.serve's reading, in the cell that reports
flagship_mpix_s."""

import harness

read = harness.metric_reader("roofline.serve")
