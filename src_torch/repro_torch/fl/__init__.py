from repro_torch.fl.messages import (  # noqa: F401
                                     FitIns, FitRes, EvaluateIns, EvaluateRes, TaskIns, TaskRes,
                                     UnsupportedCodec, WIRE_CODECS, QUANT_CODECS,
                                     arrays_to_bytes, bytes_to_arrays, params_to_arrays, arrays_to_params,
                                     encode_partial_fit_res, set_default_codec,
                                     )
from repro_torch.fl.flat import (  # noqa: F401
                                 FlatParams, Layout, PartialSum, QuantParams, layout_for, layout_of,
                                 quantize_int8, unflatten_vector,
                                 )
from repro_torch.fl.client import Client, ClientApp, NumPyClient  # noqa: F401
from repro_torch.fl.server import ServerApp, ServerConfig, Driver  # noqa: F401
from repro_torch.fl.registry import PopulationRegistry  # noqa: F401
from repro_torch.fl.fedbuff import FedBuffBuffer  # noqa: F401
from repro_torch.fl.strategy import (  # noqa: F401
                                     Strategy, FitAccumulator, QuorumNotMet, FedAvg, FedAdam, FedYogi,
                                     FedAvgM, FedProx, FedMedian, FedTrimmedMean, Krum, make_strategy,
                                     weighted_average,
                                     )
