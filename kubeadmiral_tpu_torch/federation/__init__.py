"""The scheduling half of the control plane: the cluster, federate and
scheduler controllers and their shared helpers."""
