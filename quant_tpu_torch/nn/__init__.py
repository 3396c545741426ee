"""Modules of the port: eval-form layers, the QResNet families, QLeNet5
and the serving preparation (export, calibrate, fold, strip)."""
