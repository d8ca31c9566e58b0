"""Command-line tools of the port.

The exit-code boundary is the reference's own `smallk_tpu.cli.run_cli`
(framework-free), shared by import.
"""
