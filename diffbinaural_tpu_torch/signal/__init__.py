from .filters import (
    DownSample1d,
    LowPassFilter1d,
    UpSample1d,
    kaiser_sinc_filter1d,
)
