"""The paper's MAC-array benchmarks on the port: Fig. 14/15
(``mac_efficiency``) and Fig. 22/23 (``dnn_layers``).  Each is runnable
as ``python -m repro_torch.bench.<name>`` and prints the reference's
``name,us,derived`` rows."""
