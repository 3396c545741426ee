"""General traffic drivers: a traffic mix (portbench/traffic/<mix>.json)
names one by its `driver` key and gives its parameters."""
