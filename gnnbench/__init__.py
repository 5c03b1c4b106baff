"""The port's benchmark: whole-graph passes and open-loop subgraph serving
of the paper's GNNs on one card.  ``python3 gnnbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` runs one cell once."""
