"""Modules of the port: eval-form layers, the xnor QResNet and the
serving preparation (export, fold, strip)."""
