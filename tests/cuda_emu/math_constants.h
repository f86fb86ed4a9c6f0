#pragma once
#define CUDART_INF_F INFINITY
