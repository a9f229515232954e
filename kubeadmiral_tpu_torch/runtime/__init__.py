"""Runtime surfaces of the port: metrics, the decision flight recorder
and durable engine snapshots."""
