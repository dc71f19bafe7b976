"""The optical-flow task of the port (counterpart of
densematchingbenchmark_tpu/flow/): .flo files, the FlyingChairs and
synthetic datasets, flow-aware transforms, EPE / n-px metrics, the
multi-scale loss, the colour wheel, the PWCFlow and RAFT models and their
trainer."""

from .datasets import FlyingChairsDataset, SyntheticFlowDataset
from .io import load_flo, save_flo
from .losses import flow_l1_loss
from .metrics import calc_flow_error
from .models import FLOW_META_ARCHITECTURES, PWCFlow, build_flow_model
from .raft import RAFTFlow
from .vis import SaveFlowResultTool, flow_to_color

__all__ = ["FlyingChairsDataset", "SyntheticFlowDataset", "load_flo",
           "save_flo", "flow_l1_loss", "calc_flow_error",
           "FLOW_META_ARCHITECTURES", "PWCFlow", "RAFTFlow",
           "build_flow_model", "SaveFlowResultTool", "flow_to_color"]
