"""MLLess core (port of ``repro.core``): the ISP significance filter, the
consistency models, the scale-in auto-tuner, the billing and cost models
and the serverless execution simulator. Names are imported on first use.
"""

from repro_torch._exports import lazy

_ISP = "repro_torch.core.isp"
_BILL = "repro_torch.core.billing"
_SIM = "repro_torch.core.simulator"
__getattr__ = lazy(__name__, {
    "ISPConfig": (_ISP, "ISPConfig"),
    "ISPState": (_ISP, "ISPState"),
    "init_state": (_ISP, "init_state"),
    "filter_update": (_ISP, "filter_update"),
    "significance_split": (_ISP, "significance_split"),
    "communicated_fraction": (_ISP, "communicated_fraction"),
    "ConsistencyConfig": ("repro_torch.core.consistency",
                          "ConsistencyConfig"),
    "Model": ("repro_torch.core.consistency", "Model"),
    "AutoTunerConfig": ("repro_torch.core.autotuner", "AutoTunerConfig"),
    "ScaleInAutoTuner": ("repro_torch.core.autotuner", "ScaleInAutoTuner"),
    "CommModel": (_BILL, "CommModel"),
    "faas_cost": (_BILL, "faas_cost"),
    "iaas_cost": (_BILL, "iaas_cost"),
    "perf_per_dollar": (_BILL, "perf_per_dollar"),
    "Platform": (_SIM, "Platform"),
    "ServerlessSimulator": (_SIM, "ServerlessSimulator"),
    "SimulatorConfig": (_SIM, "SimulatorConfig"),
})
