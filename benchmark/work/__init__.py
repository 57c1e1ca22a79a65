"""The work a kernel's roofline is measured against, counted from what the
frame needs (shapes and the benchmark's own scene), and the chip's peaks."""
