"""TPC-DS (port of ``datafusion_comet_tpu/models/tpcds.py``): the 24
tables' schemas and skewed-key generator, bit for bit, and all 99 queries,
with q90's scalar-subquery form (``q90_scalar``) beside them.

The generator draws fact-table join keys from a Zipf-like distribution
(``_zipf_keys``, a = 1.3), so the joins fan out unevenly and a grace
partition can hold far more than its share. Each table's random stream is
seeded by the crc32 of its name, so both packages give the same columns in
any process.

The queries cover star joins with a grouped aggregate (q3, q42, q52, q55,
q19, q7), ticket aggregation (q34, q68, q73, q79), semi joins across
channels (q95), day-of-week pivots through ``sum(if_(...))`` (q43, q62, q99,
q50), ratios of scalar aggregates (q90), ROLLUP through ``Expand``
(``_rollup``: q5, q14, q18, q22, q27, q77, q80), the three channels under a
``Union`` (q2, q5, q33, q56, q60, q66, q71, q75, q76 and more), and
EXISTS / NOT EXISTS as semi and anti joins, and windows: class revenue
ratios (q12, q20, q98), ranks within a ROLLUP's parent (q36, q70, q86),
top-100 ranks (q67, q44, q49), deviation from a partition's average (q53,
q63, q89), lag and lead around monthly outliers (q47, q57) and running sums
and maxima through a FULL join (q51); q17 takes ``MathFunc`` sqrt and q39
``stddev_samp``; q88's eight counts are scalar subqueries. ``QUERIES``
lists them. A query of ``NEEDS_SESSION`` registers its scalar subqueries in
the session that will run it: build every plan with ``plan(q, session)``,
and take the tables a query reads, its subqueries' included, from
``tables(q)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["SCHEMAS", "generate_table", "generate_tables", "QUERIES", "NEEDS_SESSION", "plan",
           "tables", "q90_scalar"]

_dec = T.decimal

SCHEMAS: Dict[str, T.Schema] = {
    "date_dim": T.Schema(
        [
            T.Field("d_date_sk", T.INT64, False),
            T.Field("d_year", T.INT32, False),
            T.Field("d_moy", T.INT32, False),
            T.Field("d_dom", T.INT32, False),
            T.Field("d_dow", T.INT32, False),
            T.Field("d_qoy", T.INT32, False),
            T.Field("d_day_name", T.string(9), False),
            T.Field("d_month_seq", T.INT32, False),
            T.Field("d_week_seq", T.INT32, False),
        ]
    ),
    "time_dim": T.Schema(
        [
            T.Field("t_time_sk", T.INT64, False),
            T.Field("t_hour", T.INT32, False),
            T.Field("t_minute", T.INT32, False),
        ]
    ),
    "item": T.Schema(
        [
            T.Field("i_item_sk", T.INT64, False),
            T.Field("i_item_id", T.string(16), False),
            T.Field("i_item_desc", T.string(40), False),
            T.Field("i_brand_id", T.INT32, False),
            T.Field("i_brand", T.string(30), False),
            T.Field("i_manufact_id", T.INT32, False),
            T.Field("i_manager_id", T.INT32, False),
            T.Field("i_category", T.string(12), False),
            T.Field("i_class", T.string(12), False),
            T.Field("i_current_price", _dec(7, 2), False),
            T.Field("i_product_name", T.string(24), False),
            T.Field("i_color", T.string(10), False),
            T.Field("i_manufact", T.string(16), False),
        ]
    ),
    "store": T.Schema(
        [
            T.Field("s_store_sk", T.INT64, False),
            T.Field("s_store_id", T.string(16), False),
            T.Field("s_store_name", T.string(12), False),
            T.Field("s_county", T.string(20), False),
            T.Field("s_city", T.string(12), False),
            T.Field("s_state", T.string(2), False),
            T.Field("s_zip", T.string(5), False),
        ]
    ),
    "warehouse": T.Schema(
        [
            T.Field("w_warehouse_sk", T.INT64, False),
            T.Field("w_warehouse_name", T.string(20), False),
            T.Field("w_state", T.string(2), False),
            T.Field("w_warehouse_sq_ft", T.INT32, False),
        ]
    ),
    "ship_mode": T.Schema(
        [
            T.Field("sm_ship_mode_sk", T.INT64, False),
            T.Field("sm_type", T.string(12), False),
        ]
    ),
    "web_site": T.Schema(
        [
            T.Field("web_site_sk", T.INT64, False),
            T.Field("web_name", T.string(12), False),
        ]
    ),
    "call_center": T.Schema(
        [
            T.Field("cc_call_center_sk", T.INT64, False),
            T.Field("cc_name", T.string(20), False),
        ]
    ),
    "household_demographics": T.Schema(
        [
            T.Field("hd_demo_sk", T.INT64, False),
            T.Field("hd_buy_potential", T.string(12), False),
            T.Field("hd_dep_count", T.INT32, False),
            T.Field("hd_vehicle_count", T.INT32, False),
            T.Field("hd_income_band_sk", T.INT64, False),
        ]
    ),
    "customer_demographics": T.Schema(
        [
            T.Field("cd_demo_sk", T.INT64, False),
            T.Field("cd_gender", T.string(1), False),
            T.Field("cd_marital_status", T.string(1), False),
            T.Field("cd_education_status", T.string(16), False),
            T.Field("cd_purchase_estimate", T.INT32, False),
            T.Field("cd_credit_rating", T.string(10), False),
            T.Field("cd_dep_count", T.INT32, False),
            T.Field("cd_dep_employed_count", T.INT32, False),
            T.Field("cd_dep_college_count", T.INT32, False),
        ]
    ),
    "customer_address": T.Schema(
        [
            T.Field("ca_address_sk", T.INT64, False),
            T.Field("ca_city", T.string(12), False),
            T.Field("ca_state", T.string(2), False),
            T.Field("ca_zip", T.string(5), False),
            T.Field("ca_gmt_offset", T.INT32, False),
            T.Field("ca_county", T.string(20), False),
        ]
    ),
    "promotion": T.Schema(
        [
            T.Field("p_promo_sk", T.INT64, False),
            T.Field("p_channel_email", T.string(1), False),
            T.Field("p_channel_event", T.string(1), False),
            T.Field("p_channel_dmail", T.string(1), False),
            T.Field("p_channel_tv", T.string(1), False),
        ]
    ),
    "customer": T.Schema(
        [
            T.Field("c_customer_sk", T.INT64, False),
            T.Field("c_current_addr_sk", T.INT64, False),
            T.Field("c_last_name", T.string(20), False),
            T.Field("c_first_name", T.string(16), False),
            T.Field("c_salutation", T.string(6), False),
            T.Field("c_preferred_cust_flag", T.string(1), False),
            T.Field("c_customer_id", T.string(16), False),
            T.Field("c_current_cdemo_sk", T.INT64, False),
            T.Field("c_current_hdemo_sk", T.INT64, False),
            T.Field("c_birth_year", T.INT32, False),
        ]
    ),
    "store_sales": T.Schema(
        [
            T.Field("ss_sold_date_sk", T.INT64, False),
            T.Field("ss_sold_time_sk", T.INT64, False),
            T.Field("ss_item_sk", T.INT64, False),
            T.Field("ss_customer_sk", T.INT64, False),
            T.Field("ss_cdemo_sk", T.INT64, False),
            T.Field("ss_addr_sk", T.INT64, False),
            T.Field("ss_store_sk", T.INT64, False),
            T.Field("ss_hdemo_sk", T.INT64, False),
            T.Field("ss_promo_sk", T.INT64, False),
            T.Field("ss_ticket_number", T.INT64, False),
            T.Field("ss_quantity", T.INT32, False),
            T.Field("ss_sales_price", _dec(7, 2), False),
            T.Field("ss_list_price", _dec(7, 2), False),
            T.Field("ss_ext_sales_price", _dec(7, 2), False),
            T.Field("ss_ext_discount_amt", _dec(7, 2), False),
            T.Field("ss_ext_wholesale_cost", _dec(7, 2), False),
            T.Field("ss_coupon_amt", _dec(7, 2), False),
            T.Field("ss_net_profit", _dec(7, 2), False),
            T.Field("ss_wholesale_cost", _dec(7, 2), False),
            T.Field("ss_ext_list_price", _dec(7, 2), False),
            T.Field("ss_net_paid", _dec(7, 2), False),
        ]
    ),
    "store_returns": T.Schema(
        [
            T.Field("sr_item_sk", T.INT64, False),
            T.Field("sr_customer_sk", T.INT64, False),
            T.Field("sr_ticket_number", T.INT64, False),
            T.Field("sr_returned_date_sk", T.INT64, False),
            T.Field("sr_return_amt", _dec(7, 2), False),
            T.Field("sr_store_sk", T.INT64, False),
            T.Field("sr_reason_sk", T.INT64, False),
            T.Field("sr_cdemo_sk", T.INT64, False),
            T.Field("sr_net_loss", _dec(7, 2), False),
            T.Field("sr_return_quantity", T.INT32, False),
        ]
    ),
    "web_sales": T.Schema(
        [
            T.Field("ws_order_number", T.INT64, False),
            T.Field("ws_item_sk", T.INT64, False),
            T.Field("ws_sold_time_sk", T.INT64, False),
            T.Field("ws_warehouse_sk", T.INT64, False),
            T.Field("ws_sold_date_sk", T.INT64, False),
            T.Field("ws_ship_date_sk", T.INT64, False),
            T.Field("ws_ship_addr_sk", T.INT64, False),
            T.Field("ws_bill_customer_sk", T.INT64, False),
            T.Field("ws_web_site_sk", T.INT64, False),
            T.Field("ws_ship_mode_sk", T.INT64, False),
            T.Field("ws_sales_price", _dec(7, 2), False),
            T.Field("ws_ext_ship_cost", _dec(7, 2), False),
            T.Field("ws_ext_sales_price", _dec(7, 2), False),
            T.Field("ws_net_profit", _dec(7, 2), False),
            T.Field("ws_quantity", T.INT32, False),
            T.Field("ws_ext_discount_amt", _dec(7, 2), False),
            T.Field("ws_ext_list_price", _dec(7, 2), False),
            T.Field("ws_net_paid", _dec(7, 2), False),
            T.Field("ws_web_page_sk", T.INT64, False),
        ]
    ),
    "web_returns": T.Schema(
        [
            T.Field("wr_order_number", T.INT64, False),
            T.Field("wr_item_sk", T.INT64, False),
            T.Field("wr_returned_date_sk", T.INT64, False),
            T.Field("wr_returning_customer_sk", T.INT64, False),
            T.Field("wr_refunded_cash", _dec(7, 2), False),
            T.Field("wr_return_amt", _dec(7, 2), False),
            T.Field("wr_net_loss", _dec(7, 2), False),
            T.Field("wr_reason_sk", T.INT64, False),
            T.Field("wr_web_page_sk", T.INT64, False),
            T.Field("wr_return_quantity", T.INT32, False),
        ]
    ),
    "catalog_sales": T.Schema(
        [
            T.Field("cs_sold_date_sk", T.INT64, False),
            T.Field("cs_ship_date_sk", T.INT64, False),
            T.Field("cs_item_sk", T.INT64, False),
            T.Field("cs_bill_customer_sk", T.INT64, False),
            T.Field("cs_warehouse_sk", T.INT64, False),
            T.Field("cs_ship_mode_sk", T.INT64, False),
            T.Field("cs_call_center_sk", T.INT64, False),
            T.Field("cs_cdemo_sk", T.INT64, False),
            T.Field("cs_promo_sk", T.INT64, False),
            T.Field("cs_quantity", T.INT32, False),
            T.Field("cs_sales_price", _dec(7, 2), False),
            T.Field("cs_list_price", _dec(7, 2), False),
            T.Field("cs_coupon_amt", _dec(7, 2), False),
            T.Field("cs_ext_sales_price", _dec(7, 2), False),
            T.Field("cs_net_profit", _dec(7, 2), False),
            T.Field("cs_order_number", T.INT64, False),
            T.Field("cs_ext_discount_amt", _dec(7, 2), False),
            T.Field("cs_ext_list_price", _dec(7, 2), False),
            T.Field("cs_ext_ship_cost", _dec(7, 2), False),
            T.Field("cs_ship_addr_sk", T.INT64, False),
            T.Field("cs_catalog_page_sk", T.INT64, False),
            T.Field("cs_sold_time_sk", T.INT64, False),
        ]
    ),
    "catalog_returns": T.Schema(
        [
            T.Field("cr_item_sk", T.INT64, False),
            T.Field("cr_order_number", T.INT64, False),
            T.Field("cr_returned_date_sk", T.INT64, False),
            T.Field("cr_returning_customer_sk", T.INT64, False),
            T.Field("cr_call_center_sk", T.INT64, False),
            T.Field("cr_reason_sk", T.INT64, False),
            T.Field("cr_catalog_page_sk", T.INT64, False),
            T.Field("cr_return_amount", _dec(7, 2), False),
            T.Field("cr_net_loss", _dec(7, 2), False),
            T.Field("cr_return_quantity", T.INT32, False),
        ]
    ),
    "inventory": T.Schema(
        [
            T.Field("inv_date_sk", T.INT64, False),
            T.Field("inv_item_sk", T.INT64, False),
            T.Field("inv_warehouse_sk", T.INT64, False),
            T.Field("inv_quantity_on_hand", T.INT32, False),
        ]
    ),
    "reason": T.Schema(
        [
            T.Field("r_reason_sk", T.INT64, False),
            T.Field("r_reason_desc", T.string(20), False),
        ]
    ),
    "web_page": T.Schema(
        [
            T.Field("wp_web_page_sk", T.INT64, False),
            T.Field("wp_char_count", T.INT32, False),
        ]
    ),
    "income_band": T.Schema(
        [
            T.Field("ib_income_band_sk", T.INT64, False),
            T.Field("ib_lower_bound", T.INT32, False),
            T.Field("ib_upper_bound", T.INT32, False),
        ]
    ),
    "catalog_page": T.Schema(
        [
            T.Field("cp_catalog_page_sk", T.INT64, False),
            T.Field("cp_catalog_page_id", T.string(16), False),
        ]
    ),
}

_BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500", "Unknown"]


def _zipf_keys(rng, n, max_key, a=1.3):
    """Skewed join keys in [1, max_key] (Zipf truncated)."""
    z = rng.zipf(a, n)
    return ((z - 1) % max_key + 1).astype(np.int64)


DATA_VERSION = 2  # v2: process-stable per-table rng seeding (crc32)


def table_rows(name: str, sf: float) -> int:
    base = {
        "date_dim": 2000,
        "time_dim": 1440,
        "item": 2000,
        "store": 12,
        "warehouse": 6,
        "ship_mode": 10,
        "web_site": 8,
        "call_center": 6,
        "household_demographics": 720,
        "customer_demographics": 1000,
        "customer_address": 3000,
        "promotion": 100,
        "customer": 10000,
        "store_sales": 300000,
        "store_returns": 30000,
        "web_sales": 60000,
        "web_returns": 6000,
        "catalog_sales": 90000,
        "catalog_returns": 9000,
        "inventory": 40000,
        "reason": 10,
        "web_page": 20,
        "income_band": 20,
        "catalog_page": 100,
    }[name]
    fixed = (
        "date_dim", "time_dim", "store", "warehouse", "ship_mode", "web_site",
        "call_center", "household_demographics", "customer_demographics", "promotion",
        "reason", "web_page", "income_band", "catalog_page",
    )
    if name in fixed:
        return base
    return max(int(base * sf), 10)


def generate_table(name: str, sf: float, seed: int = 20030101) -> Dict[str, np.ndarray]:
    n = table_rows(name, sf)
    # stable per-table stream: hash() is PYTHONHASHSEED-randomized per
    # process, which made generated data differ run-to-run — the root
    # cause of the test_tpcds9::test_q17 cross-run flake (engine and
    # oracle both correct, but knife-edge float/tie comparisons moved
    # with the data). crc32 is process-stable.
    import zlib

    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**31))
    if name == "date_dim":
        sk = np.arange(1, n + 1, dtype=np.int64)
        year = 1998 + (sk - 1) // 365
        doy = (sk - 1) % 365
        moy = (doy // 30) % 12 + 1
        dom = doy % 30 + 1
        dow = (sk - 1) % 7
        day_names = np.array(
            ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday", "Sunday"],
            object,
        )
        return {
            "d_date_sk": sk,
            "d_year": year.astype(np.int32),
            "d_moy": moy.astype(np.int32),
            "d_dom": dom.astype(np.int32),
            "d_dow": dow.astype(np.int32),
            "d_qoy": ((moy - 1) // 3 + 1).astype(np.int32),
            "d_day_name": day_names[dow],
            "d_month_seq": ((year - 1998) * 12 + moy - 1).astype(np.int32),
            "d_week_seq": ((sk - 1) // 7).astype(np.int32),
        }
    if name == "time_dim":
        sk = np.arange(0, n, dtype=np.int64)
        return {
            "t_time_sk": sk,
            "t_hour": (sk // 60).astype(np.int32),
            "t_minute": (sk % 60).astype(np.int32),
        }
    if name == "item":
        sk = np.arange(1, n + 1, dtype=np.int64)
        brand = rng.integers(1, 1000, n).astype(np.int32)
        cats = np.array(["Books", "Electronics", "Home", "Jewelry", "Men", "Music",
                         "Shoes", "Sports", "Children", "Women"], object)
        return {
            "i_item_sk": sk,
            "i_item_id": np.array([f"ITEM{k:012d}" for k in sk], object),
            "i_item_desc": np.array([f"desc of item {k}" for k in sk], object),
            "i_brand_id": brand,
            "i_brand": np.array([f"brand#{b}" for b in brand], object),
            "i_manufact_id": rng.integers(1, 1000, n).astype(np.int32),
            "i_manager_id": rng.integers(1, 100, n).astype(np.int32),
            "i_category": cats[rng.integers(0, len(cats), n)],
            "i_class": np.array([f"class{x:02d}" for x in rng.integers(0, 16, n)], object),
            "i_current_price": rng.integers(99, 30000, n).astype(np.int64),
            "i_product_name": np.array([f"product{k:08d}" for k in sk], object),
            "i_color": np.array(
                ["red", "blue", "green", "black", "white", "navy", "olive", "plum",
                 "salmon", "orchid"], object
            )[rng.integers(0, 10, n)],
            "i_manufact": np.array([f"manufact{m % 200:04d}" for m in rng.integers(1, 1000, n)], object),
        }
    if name == "store":
        return {
            "s_store_sk": np.arange(1, n + 1, dtype=np.int64),
            "s_store_id": np.array([f"STORE{i:010d}" for i in range(n)], object),
            "s_store_name": np.array([f"store_{i % 6}" for i in range(n)], object),
            "s_county": np.array([f"county {i % 8}" for i in range(n)], object),
            "s_city": np.array([f"city{i % 5}" for i in range(n)], object),
            "s_state": np.array(["TN", "CA", "TX", "NY"], object)[np.arange(n) % 4],
            "s_zip": np.array([f"{30000 + 97 * i % 60000:05d}" for i in range(n)], object),
        }
    if name == "warehouse":
        return {
            "w_warehouse_sk": np.arange(1, n + 1, dtype=np.int64),
            "w_warehouse_name": np.array([f"warehouse {i}" for i in range(n)], object),
            "w_state": np.array(["TN", "CA", "TX", "NY", "WA", "GA"], object)[np.arange(n) % 6],
            "w_warehouse_sq_ft": (50000 + 12345 * np.arange(n) % 400000).astype(np.int32),
        }
    if name == "ship_mode":
        types = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY",
                 "LIBRARY", "MAIL", "AIR", "SEA", "TRUCK"]
        return {
            "sm_ship_mode_sk": np.arange(1, n + 1, dtype=np.int64),
            "sm_type": np.array(types[:n], object),
        }
    if name == "web_site":
        return {
            "web_site_sk": np.arange(1, n + 1, dtype=np.int64),
            "web_name": np.array([f"site_{i}" for i in range(n)], object),
        }
    if name == "call_center":
        return {
            "cc_call_center_sk": np.arange(1, n + 1, dtype=np.int64),
            "cc_name": np.array([f"call center {i}" for i in range(n)], object),
        }
    if name == "customer_demographics":
        return {
            "cd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
            "cd_gender": np.array(["M", "F"], object)[rng.integers(0, 2, n)],
            "cd_marital_status": np.array(["M", "S", "D", "W", "U"], object)[rng.integers(0, 5, n)],
            "cd_education_status": np.array(
                ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
                 "Advanced Degree", "Unknown"], object
            )[rng.integers(0, 7, n)],
            "cd_purchase_estimate": (rng.integers(0, 20, n) * 500).astype(np.int32),
            "cd_credit_rating": np.array(
                ["Low Risk", "High Risk", "Good", "Unknown"], object
            )[rng.integers(0, 4, n)],
            "cd_dep_count": rng.integers(0, 7, n).astype(np.int32),
            "cd_dep_employed_count": rng.integers(0, 7, n).astype(np.int32),
            "cd_dep_college_count": rng.integers(0, 7, n).astype(np.int32),
        }
    if name == "customer_address":
        states = np.array(["CA", "TX", "NY", "FL", "WA", "GA", "IL", "OH"], object)
        return {
            "ca_address_sk": np.arange(1, n + 1, dtype=np.int64),
            "ca_city": np.array([f"city{i % 40}" for i in range(n)], object),
            "ca_state": states[rng.integers(0, len(states), n)],
            "ca_zip": np.array([f"{z:05d}" for z in rng.integers(10000, 99999, n)], object),
            "ca_gmt_offset": rng.integers(-8, -4, n).astype(np.int32),
            "ca_county": np.array([f"county {i % 8}" for i in rng.integers(0, 8, n)], object),
        }
    if name == "promotion":
        yn = np.array(["Y", "N"], object)
        return {
            "p_promo_sk": np.arange(1, n + 1, dtype=np.int64),
            "p_channel_email": yn[rng.integers(0, 2, n)],
            "p_channel_event": yn[rng.integers(0, 2, n)],
            "p_channel_dmail": yn[rng.integers(0, 2, n)],
            "p_channel_tv": yn[rng.integers(0, 2, n)],
        }
    if name == "household_demographics":
        return {
            "hd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
            "hd_buy_potential": np.array(_BUY_POTENTIAL, object)[rng.integers(0, 6, n)],
            "hd_dep_count": rng.integers(0, 10, n).astype(np.int32),
            "hd_vehicle_count": rng.integers(-1, 5, n).astype(np.int32),
            "hd_income_band_sk": rng.integers(1, 21, n).astype(np.int64),
        }
    if name == "customer":
        sk = np.arange(1, n + 1, dtype=np.int64)
        return {
            "c_customer_sk": sk,
            "c_current_addr_sk": rng.integers(1, max(int(3000 * sf), 10) + 1, n).astype(np.int64),
            "c_last_name": np.array([f"Last{k % 500:03d}" for k in sk], object),
            "c_first_name": np.array([f"First{k % 300:03d}" for k in sk], object),
            "c_salutation": np.array(["Mr.", "Ms.", "Dr.", "Mrs.", "Sir"], object)[rng.integers(0, 5, n)],
            "c_preferred_cust_flag": np.array(["Y", "N"], object)[rng.integers(0, 2, n)],
            "c_customer_id": np.array([f"CUST{k:012d}" for k in sk], object),
            "c_current_cdemo_sk": rng.integers(1, 1001, n).astype(np.int64),
            "c_current_hdemo_sk": rng.integers(1, 721, n).astype(np.int64),
            "c_birth_year": rng.integers(1930, 1995, n).astype(np.int32),
        }
    if name == "store_sales":
        qty = rng.integers(1, 100, n).astype(np.int32)
        sales_price = rng.integers(100, 20000, n).astype(np.int64)
        return {
            "ss_sold_date_sk": rng.integers(1, table_rows("date_dim", sf) + 1, n).astype(np.int64),
            "ss_sold_time_sk": rng.integers(0, 1440, n).astype(np.int64),
            "ss_item_sk": _zipf_keys(rng, n, table_rows("item", sf)),  # skewed
            "ss_customer_sk": _zipf_keys(rng, n, table_rows("customer", sf)),
            "ss_cdemo_sk": rng.integers(1, 1001, n).astype(np.int64),
            "ss_addr_sk": rng.integers(1, max(int(3000 * sf), 10) + 1, n).astype(np.int64),
            "ss_store_sk": rng.integers(1, table_rows("store", sf) + 1, n).astype(np.int64),
            "ss_hdemo_sk": rng.integers(1, table_rows("household_demographics", sf) + 1, n).astype(np.int64),
            "ss_promo_sk": rng.integers(1, 101, n).astype(np.int64),
            "ss_ticket_number": rng.integers(1, max(n // 6, 2), n).astype(np.int64),
            "ss_quantity": qty,
            "ss_sales_price": sales_price,
            "ss_list_price": sales_price + rng.integers(0, 5000, n).astype(np.int64),
            "ss_ext_sales_price": rng.integers(100, 1000000, n).astype(np.int64),
            "ss_ext_discount_amt": rng.integers(0, 50000, n).astype(np.int64),
            "ss_ext_wholesale_cost": rng.integers(50, 500000, n).astype(np.int64),
            "ss_coupon_amt": rng.integers(0, 20000, n).astype(np.int64),
            "ss_net_profit": rng.integers(-50000, 200000, n).astype(np.int64),
            "ss_wholesale_cost": rng.integers(50, 10000, n).astype(np.int64),
            "ss_ext_list_price": rng.integers(100, 1200000, n).astype(np.int64),
            "ss_net_paid": rng.integers(100, 900000, n).astype(np.int64),
        }
    if name == "store_returns":
        nss = table_rows("store_sales", sf)
        return {
            "sr_item_sk": _zipf_keys(rng, n, table_rows("item", sf)),
            "sr_customer_sk": _zipf_keys(rng, n, table_rows("customer", sf)),
            "sr_ticket_number": rng.integers(1, max(nss // 6, 2), n).astype(np.int64),
            "sr_returned_date_sk": rng.integers(1, table_rows("date_dim", sf) + 1, n).astype(np.int64),
            "sr_return_amt": rng.integers(100, 50000, n).astype(np.int64),
            "sr_store_sk": rng.integers(1, table_rows("store", sf) + 1, n).astype(np.int64),
            "sr_reason_sk": rng.integers(1, 11, n).astype(np.int64),
            "sr_cdemo_sk": rng.integers(1, 1001, n).astype(np.int64),
            "sr_net_loss": rng.integers(100, 30000, n).astype(np.int64),
            "sr_return_quantity": rng.integers(1, 50, n).astype(np.int32),
        }
    if name == "web_sales":
        return {
            "ws_order_number": rng.integers(1, max(n // 4, 2), n).astype(np.int64),
            "ws_item_sk": _zipf_keys(rng, n, table_rows("item", sf)),
            "ws_sold_time_sk": rng.integers(0, 1440, n).astype(np.int64),
            "ws_warehouse_sk": rng.integers(1, 6, n).astype(np.int64),
            "ws_sold_date_sk": rng.integers(1, table_rows("date_dim", sf) + 1, n).astype(np.int64),
            "ws_ship_date_sk": rng.integers(1, table_rows("date_dim", sf) + 1, n).astype(np.int64),
            "ws_ship_addr_sk": rng.integers(1, max(int(3000 * sf), 10) + 1, n).astype(np.int64),
            "ws_bill_customer_sk": _zipf_keys(rng, n, table_rows("customer", sf)),
            "ws_web_site_sk": rng.integers(1, 9, n).astype(np.int64),
            "ws_ship_mode_sk": rng.integers(1, 11, n).astype(np.int64),
            "ws_sales_price": rng.integers(100, 20000, n).astype(np.int64),
            "ws_ext_ship_cost": rng.integers(100, 10000, n).astype(np.int64),
            "ws_ext_sales_price": rng.integers(100, 100000, n).astype(np.int64),
            "ws_net_profit": rng.integers(-5000, 20000, n).astype(np.int64),
            "ws_quantity": rng.integers(1, 100, n).astype(np.int32),
            "ws_ext_discount_amt": rng.integers(0, 50000, n).astype(np.int64),
            "ws_ext_list_price": rng.integers(100, 1200000, n).astype(np.int64),
            "ws_net_paid": rng.integers(100, 900000, n).astype(np.int64),
            "ws_web_page_sk": rng.integers(1, 21, n).astype(np.int64),
        }
    if name == "web_returns":
        return {
            "wr_order_number": rng.integers(1, max(table_rows("web_sales", sf) // 4, 2), n).astype(np.int64),
            "wr_item_sk": _zipf_keys(rng, n, table_rows("item", sf)),
            "wr_returned_date_sk": rng.integers(1, table_rows("date_dim", sf) + 1, n).astype(np.int64),
            "wr_returning_customer_sk": _zipf_keys(rng, n, table_rows("customer", sf)),
            "wr_refunded_cash": rng.integers(100, 40000, n).astype(np.int64),
            "wr_return_amt": rng.integers(100, 50000, n).astype(np.int64),
            "wr_net_loss": rng.integers(100, 30000, n).astype(np.int64),
            "wr_reason_sk": rng.integers(1, 11, n).astype(np.int64),
            "wr_web_page_sk": rng.integers(1, 21, n).astype(np.int64),
            "wr_return_quantity": rng.integers(1, 50, n).astype(np.int32),
        }
    if name == "catalog_sales":
        return {
            "cs_sold_date_sk": rng.integers(1, table_rows("date_dim", sf) + 1, n).astype(np.int64),
            "cs_ship_date_sk": rng.integers(1, table_rows("date_dim", sf) + 1, n).astype(np.int64),
            "cs_item_sk": _zipf_keys(rng, n, table_rows("item", sf)),
            "cs_bill_customer_sk": _zipf_keys(rng, n, table_rows("customer", sf)),
            "cs_warehouse_sk": rng.integers(1, 7, n).astype(np.int64),
            "cs_ship_mode_sk": rng.integers(1, 11, n).astype(np.int64),
            "cs_call_center_sk": rng.integers(1, 7, n).astype(np.int64),
            "cs_cdemo_sk": rng.integers(1, 1001, n).astype(np.int64),
            "cs_promo_sk": rng.integers(1, 101, n).astype(np.int64),
            "cs_quantity": rng.integers(1, 100, n).astype(np.int32),
            "cs_sales_price": rng.integers(100, 20000, n).astype(np.int64),
            "cs_list_price": rng.integers(100, 25000, n).astype(np.int64),
            "cs_coupon_amt": rng.integers(0, 20000, n).astype(np.int64),
            "cs_ext_sales_price": rng.integers(100, 100000, n).astype(np.int64),
            "cs_net_profit": rng.integers(-5000, 50000, n).astype(np.int64),
            "cs_order_number": rng.integers(1, max(n // 4, 2), n).astype(np.int64),
            "cs_ext_discount_amt": rng.integers(0, 50000, n).astype(np.int64),
            "cs_ext_list_price": rng.integers(100, 1200000, n).astype(np.int64),
            "cs_ext_ship_cost": rng.integers(100, 10000, n).astype(np.int64),
            "cs_ship_addr_sk": rng.integers(1, max(int(3000 * sf), 10) + 1, n).astype(np.int64),
            "cs_catalog_page_sk": rng.integers(1, 101, n).astype(np.int64),
            "cs_sold_time_sk": rng.integers(0, 1440, n).astype(np.int64),
        }
    if name == "catalog_returns":
        ncs = table_rows("catalog_sales", sf)
        return {
            "cr_item_sk": _zipf_keys(rng, n, table_rows("item", sf)),
            "cr_order_number": rng.integers(1, max(ncs // 4, 2), n).astype(np.int64),
            "cr_returned_date_sk": rng.integers(1, table_rows("date_dim", sf) + 1, n).astype(np.int64),
            "cr_returning_customer_sk": _zipf_keys(rng, n, table_rows("customer", sf)),
            "cr_call_center_sk": rng.integers(1, 7, n).astype(np.int64),
            "cr_reason_sk": rng.integers(1, 11, n).astype(np.int64),
            "cr_catalog_page_sk": rng.integers(1, 101, n).astype(np.int64),
            "cr_return_amount": rng.integers(100, 50000, n).astype(np.int64),
            "cr_net_loss": rng.integers(100, 30000, n).astype(np.int64),
            "cr_return_quantity": rng.integers(1, 50, n).astype(np.int32),
        }
    if name == "inventory":
        return {
            "inv_date_sk": rng.integers(1, table_rows("date_dim", sf) + 1, n).astype(np.int64),
            "inv_item_sk": rng.integers(1, table_rows("item", sf) + 1, n).astype(np.int64),
            "inv_warehouse_sk": rng.integers(1, 7, n).astype(np.int64),
            "inv_quantity_on_hand": rng.integers(0, 1000, n).astype(np.int32),
        }
    if name == "reason":
        return {
            "r_reason_sk": np.arange(1, n + 1, dtype=np.int64),
            "r_reason_desc": np.array([f"reason {i}" for i in range(n)], object),
        }
    if name == "web_page":
        return {
            "wp_web_page_sk": np.arange(1, n + 1, dtype=np.int64),
            "wp_char_count": (2500 + 301 * np.arange(n) % 5000).astype(np.int32),
        }
    if name == "income_band":
        sk = np.arange(1, n + 1, dtype=np.int64)
        return {
            "ib_income_band_sk": sk,
            "ib_lower_bound": ((sk - 1) * 10000).astype(np.int32),
            "ib_upper_bound": (sk * 10000).astype(np.int32),
        }
    if name == "catalog_page":
        return {
            "cp_catalog_page_sk": np.arange(1, n + 1, dtype=np.int64),
            "cp_catalog_page_id": np.array([f"PAGE{i:012d}" for i in range(n)], object),
        }
    raise KeyError(name)


def generate_tables(names, sf: float, seed: int = 20030101):
    return {n: generate_table(n, sf, seed) for n in names}


def q3(max_groups: int = 1 << 14) -> P.PlanNode:
    """Brand revenue for manufacturer 128 in November, by year."""
    dt = P.Scan("date_dim", SCHEMAS["date_dim"]).filter(E.col("d_moy") == E.lit(11))
    it = P.Scan("item", SCHEMAS["item"]).filter(E.col("i_manufact_id") == E.lit(128))
    ss = P.Scan("store_sales", SCHEMAS["store_sales"])
    sd = P.HashJoin(ss, dt, (E.col("ss_sold_date_sk"),), (E.col("d_date_sk"),), P.JoinType.INNER, "right")
    sdi = P.HashJoin(sd, it, (E.col("ss_item_sk"),), (E.col("i_item_sk"),), P.JoinType.INNER, "right")
    agg = sdi.aggregate(
        [E.col("d_year"), E.col("i_brand_id"), E.col("i_brand")],
        [E.AggExpr("sum", E.col("ss_ext_sales_price"), "sum_agg")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("d_year")), E.SortOrder(E.col("sum_agg"), ascending=False),
         E.SortOrder(E.col("i_brand_id"))],
        fetch=100,
    )


def q34(max_groups: int = 1 << 16) -> P.PlanNode:
    """Tickets with 15-20 items bought by specific household profiles."""
    dt = P.Scan("date_dim", SCHEMAS["date_dim"]).filter(
        ((E.col("d_dom").between(1, 3)) | (E.col("d_dom").between(25, 28)))
        & E.col("d_year").isin(1999, 2000, 2001)
    )
    hd = P.Scan("household_demographics", SCHEMAS["household_demographics"]).filter(
        ((E.col("hd_buy_potential") == E.lit(">10000"))
         | (E.col("hd_buy_potential") == E.lit("Unknown")))
        & (E.col("hd_vehicle_count") > 0)
        & (
            E.col("hd_dep_count").cast(T.FLOAT64)
            / E.CaseWhen(((E.col("hd_vehicle_count") > 0, E.col("hd_vehicle_count")),), E.lit(1)).cast(T.FLOAT64)
            > E.lit(1.2)
        )
    )
    st = P.Scan("store", SCHEMAS["store"]).filter(
        E.col("s_county").isin("county 0", "county 1", "county 2", "county 3")
    )
    ss = P.Scan("store_sales", SCHEMAS["store_sales"])
    j1 = P.HashJoin(ss, dt, (E.col("ss_sold_date_sk"),), (E.col("d_date_sk"),), P.JoinType.INNER, "right")
    j2 = P.HashJoin(j1, st, (E.col("ss_store_sk"),), (E.col("s_store_sk"),), P.JoinType.INNER, "right")
    j3 = P.HashJoin(j2, hd, (E.col("ss_hdemo_sk"),), (E.col("hd_demo_sk"),), P.JoinType.INNER, "right")
    per_ticket = j3.aggregate(
        [E.col("ss_ticket_number"), E.col("ss_customer_sk")],
        [E.AggExpr("count", None, "cnt")],
    )
    per_ticket.max_groups = max_groups
    filt = P.Filter(per_ticket, E.col("cnt").between(15, 20))
    c = P.Scan("customer", SCHEMAS["customer"])
    j4 = P.HashJoin(filt, c, (E.col("ss_customer_sk"),), (E.col("c_customer_sk"),), P.JoinType.INNER, "right")
    return j4.sort(
        [E.SortOrder(E.col("c_last_name")), E.SortOrder(E.col("c_first_name")),
         E.SortOrder(E.col("c_salutation")),
         E.SortOrder(E.col("c_preferred_cust_flag"), ascending=False),
         E.SortOrder(E.col("ss_ticket_number"))]
    ).project(
        [E.col("c_last_name"), E.col("c_first_name"), E.col("c_salutation"),
         E.col("c_preferred_cust_flag"), E.col("ss_ticket_number"), E.col("cnt")]
    )


def q95(max_groups: int = 8) -> P.PlanNode:
    """Web sales shipped from one site in a window, where the order also ships
    from another warehouse (EXISTS self-join) and was returned (EXISTS)."""
    ws1 = P.Scan("web_sales", SCHEMAS["web_sales"])
    dt = P.Scan("date_dim", SCHEMAS["date_dim"]).filter(
        E.col("d_year").isin(1999) & E.col("d_moy").between(2, 3)
    )
    j1 = P.HashJoin(ws1, dt, (E.col("ws_ship_date_sk"),), (E.col("d_date_sk"),), P.JoinType.INNER, "right")
    # ws_wh: orders shipped from >1 warehouse (self-join inequality)
    ws2 = P.Scan("web_sales", SCHEMAS["web_sales"]).project(
        [E.col("ws_order_number").alias("o2"), E.col("ws_warehouse_sk").alias("w2")]
    )
    multi = P.HashJoin(
        j1, ws2, (E.col("ws_order_number"),), (E.col("o2"),), P.JoinType.LEFT_SEMI, "right",
        condition=E.col("w2") != E.col("ws_warehouse_sk"),
    )
    wr = P.Scan("web_returns", SCHEMAS["web_returns"])
    returned = P.HashJoin(
        multi, wr, (E.col("ws_order_number"),), (E.col("wr_order_number"),), P.JoinType.LEFT_SEMI, "right"
    )
    # count(distinct order) + sums
    dedup = returned.aggregate(
        [E.col("ws_order_number")],
        [E.AggExpr("sum", E.col("ws_ext_ship_cost"), "sc"), E.AggExpr("sum", E.col("ws_net_profit"), "np")],
    )
    dedup.max_groups = 1 << 14
    agg = dedup.aggregate(
        [],
        [E.AggExpr("count", E.col("ws_order_number"), "order_count"),
         E.AggExpr("sum", E.col("sc"), "total_shipping_cost"),
         E.AggExpr("sum", E.col("np"), "total_net_profit")],
    )
    agg.max_groups = max_groups
    return agg


def _scan(name: str) -> P.PlanNode:
    return P.Scan(name, SCHEMAS[name])


def _j(left, right, lk, rk, jt=P.JoinType.INNER, side="right", cond=None):
    return P.HashJoin(left, right, tuple(E.col(k) for k in lk), tuple(E.col(k) for k in rk), jt, side, condition=cond)


def q7(max_groups: int = 1 << 12) -> P.PlanNode:
    """Average sales metrics per item for a demographic + promotion slice."""
    cd = _scan("customer_demographics").filter(
        (E.col("cd_gender") == E.lit("M"))
        & (E.col("cd_marital_status") == E.lit("S"))
        & (E.col("cd_education_status") == E.lit("College"))
    )
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2000))
    pr = _scan("promotion").filter(
        (E.col("p_channel_email") == E.lit("N")) | (E.col("p_channel_event") == E.lit("N"))
    )
    j = _j(_scan("store_sales"), cd, ["ss_cdemo_sk"], ["cd_demo_sk"])
    j = _j(j, dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, pr, ["ss_promo_sk"], ["p_promo_sk"])
    j = _j(j, _scan("item"), ["ss_item_sk"], ["i_item_sk"])
    agg = j.aggregate(
        [E.col("i_item_id")],
        [
            E.AggExpr("avg", E.col("ss_quantity"), "agg1"),
            E.AggExpr("avg", E.col("ss_list_price"), "agg2"),
            E.AggExpr("avg", E.col("ss_coupon_amt"), "agg3"),
            E.AggExpr("avg", E.col("ss_sales_price"), "agg4"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort([E.SortOrder(E.col("i_item_id"))], fetch=100)


def q15(max_groups: int = 1 << 12) -> P.PlanNode:
    """Catalog sales by customer zip for Q2/2001, zip/state/price slice."""
    dt = _scan("date_dim").filter((E.col("d_qoy") == E.lit(2)) & (E.col("d_year") == E.lit(2001)))
    j = _j(_scan("catalog_sales"), _scan("customer"), ["cs_bill_customer_sk"], ["c_customer_sk"])
    j = _j(j, _scan("customer_address"), ["c_current_addr_sk"], ["ca_address_sk"])
    j = _j(j, dt, ["cs_sold_date_sk"], ["d_date_sk"])
    cond = (
        E.StringFunc("substring", (E.col("ca_zip"), E.lit(1), E.lit(2))).isin("85", "86", "88")
        | E.col("ca_state").isin("CA", "WA", "GA")
        | (E.col("cs_sales_price") > E.lit(100.0, T.decimal(7, 2)))
    )
    agg = P.Filter(j, cond).aggregate(
        [E.col("ca_zip")], [E.AggExpr("sum", E.col("cs_sales_price"), "total")]
    )
    agg.max_groups = max_groups
    return agg.sort([E.SortOrder(E.col("ca_zip"))], fetch=100)


def q19(max_groups: int = 1 << 12) -> P.PlanNode:
    """Brand revenue for manager-8 items in Nov 1998, bought outside the
    store's city (adaptation: city inequality instead of zip-prefix — the
    generated store table has no zip)."""
    dt = _scan("date_dim").filter((E.col("d_moy") == E.lit(11)) & (E.col("d_year") == E.lit(1998)))
    it = _scan("item").filter(E.col("i_manager_id") == E.lit(8))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, it, ["ss_item_sk"], ["i_item_sk"])
    j = _j(j, _scan("customer"), ["ss_customer_sk"], ["c_customer_sk"])
    j = _j(j, _scan("customer_address"), ["c_current_addr_sk"], ["ca_address_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"],
           cond=E.col("ca_city") != E.col("s_city"))
    agg = j.aggregate(
        [E.col("i_brand_id"), E.col("i_brand"), E.col("i_manufact_id")],
        [E.AggExpr("sum", E.col("ss_ext_sales_price"), "ext_price")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("ext_price"), ascending=False), E.SortOrder(E.col("i_brand_id"))],
        fetch=100,
    )


def _brand_month_query(manager: int, moy: int, year: int, max_groups: int) -> P.PlanNode:
    dt = _scan("date_dim").filter((E.col("d_moy") == E.lit(moy)) & (E.col("d_year") == E.lit(year)))
    it = _scan("item").filter(E.col("i_manager_id") == E.lit(manager))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, it, ["ss_item_sk"], ["i_item_sk"])
    agg = j.aggregate(
        [E.col("d_year"), E.col("i_brand_id"), E.col("i_brand")],
        [E.AggExpr("sum", E.col("ss_ext_sales_price"), "ext_price")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("d_year")), E.SortOrder(E.col("ext_price"), ascending=False),
         E.SortOrder(E.col("i_brand_id"))],
        fetch=100,
    )


def q42(max_groups: int = 1 << 12) -> P.PlanNode:
    """Category revenue for a month (q42 shape: group by category)."""
    dt = _scan("date_dim").filter((E.col("d_moy") == E.lit(11)) & (E.col("d_year") == E.lit(2000)))
    it = _scan("item").filter(E.col("i_manager_id") == E.lit(1))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, it, ["ss_item_sk"], ["i_item_sk"])
    agg = j.aggregate(
        [E.col("d_year"), E.col("i_category")],
        [E.AggExpr("sum", E.col("ss_ext_sales_price"), "total")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("total"), ascending=False), E.SortOrder(E.col("d_year")),
         E.SortOrder(E.col("i_category"))],
        fetch=100,
    )


def q52(max_groups: int = 1 << 12) -> P.PlanNode:
    return _brand_month_query(manager=1, moy=12, year=2000, max_groups=max_groups)


def q55(max_groups: int = 1 << 12) -> P.PlanNode:
    return _brand_month_query(manager=28, moy=11, year=1999, max_groups=max_groups)


def _day_case(day: str, value: str):
    return E.AggExpr(
        "sum", E.if_(E.col("d_day_name") == E.lit(day), E.col(value), E.lit(None, T.NULLTYPE)),
        f"{day[:3].lower()}_sales",
    )


def q43(max_groups: int = 64) -> P.PlanNode:
    """Store sales pivoted by day-of-week (sum(case ...)) per store."""
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2000))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday"]
    agg = j.aggregate(
        [E.col("s_store_name"), E.col("s_store_id")],
        [_day_case(d, "ss_sales_price") for d in days],
    )
    agg.max_groups = max_groups
    return agg.sort([E.SortOrder(E.col("s_store_name")), E.SortOrder(E.col("s_store_id"))], fetch=100)


def q50(max_groups: int = 64) -> P.PlanNode:
    """Return-latency buckets per store: days between sale and return."""
    ss = _scan("store_sales")
    sr = _scan("store_returns")
    j = P.HashJoin(
        ss, sr,
        (E.col("ss_ticket_number"), E.col("ss_item_sk"), E.col("ss_customer_sk")),
        (E.col("sr_ticket_number"), E.col("sr_item_sk"), E.col("sr_customer_sk")),
        P.JoinType.INNER, "right",
    )
    rdt = _scan("date_dim").filter(
        (E.col("d_year") == E.lit(2001)) & (E.col("d_moy") == E.lit(8))
    ).project([E.col("d_date_sk").alias("rd_sk")])
    j = _j(j, rdt, ["sr_returned_date_sk"], ["rd_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    lat = E.col("sr_returned_date_sk") - E.col("ss_sold_date_sk")

    def bucket(name, cond):
        return E.AggExpr("sum", E.if_(cond, E.lit(1), E.lit(None, T.NULLTYPE)), name)

    agg = j.aggregate(
        [E.col("s_store_name"), E.col("s_store_id")],
        [
            bucket("d30", lat <= E.lit(30)),
            bucket("d31_60", (lat > E.lit(30)) & (lat <= E.lit(60))),
            bucket("d61_90", (lat > E.lit(60)) & (lat <= E.lit(90))),
            bucket("d91_120", (lat > E.lit(90)) & (lat <= E.lit(120))),
            bucket("d120p", lat > E.lit(120)),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort([E.SortOrder(E.col("s_store_name")), E.SortOrder(E.col("s_store_id"))], fetch=100)


def q62(max_groups: int = 1 << 12) -> P.PlanNode:
    """Web shipping-latency buckets by warehouse/ship-mode/site."""
    ws = _scan("web_sales")
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(24, 35))
    j = _j(ws, dt, ["ws_ship_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("warehouse"), ["ws_warehouse_sk"], ["w_warehouse_sk"])
    j = _j(j, _scan("ship_mode"), ["ws_ship_mode_sk"], ["sm_ship_mode_sk"])
    j = _j(j, _scan("web_site"), ["ws_web_site_sk"], ["web_site_sk"])
    lat = E.col("ws_ship_date_sk") - E.col("ws_sold_date_sk")

    def bucket(name, cond):
        return E.AggExpr("sum", E.if_(cond, E.lit(1), E.lit(None, T.NULLTYPE)), name)

    agg = j.aggregate(
        [E.col("w_warehouse_name"), E.col("sm_type"), E.col("web_name")],
        [
            bucket("d30", lat <= E.lit(30)),
            bucket("d31_60", (lat > E.lit(30)) & (lat <= E.lit(60))),
            bucket("d61_90", (lat > E.lit(60)) & (lat <= E.lit(90))),
            bucket("d91_120", (lat > E.lit(90)) & (lat <= E.lit(120))),
            bucket("d120p", lat > E.lit(120)),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("w_warehouse_name")), E.SortOrder(E.col("sm_type")),
         E.SortOrder(E.col("web_name"))],
        fetch=100,
    )


def q99(max_groups: int = 1 << 12) -> P.PlanNode:
    """Catalog shipping-latency buckets by warehouse/ship-mode/call-center."""
    cs = _scan("catalog_sales")
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(24, 35))
    j = _j(cs, dt, ["cs_ship_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("warehouse"), ["cs_warehouse_sk"], ["w_warehouse_sk"])
    j = _j(j, _scan("ship_mode"), ["cs_ship_mode_sk"], ["sm_ship_mode_sk"])
    j = _j(j, _scan("call_center"), ["cs_call_center_sk"], ["cc_call_center_sk"])
    lat = E.col("cs_ship_date_sk") - E.col("cs_sold_date_sk")

    def bucket(name, cond):
        return E.AggExpr("sum", E.if_(cond, E.lit(1), E.lit(None, T.NULLTYPE)), name)

    agg = j.aggregate(
        [E.col("w_warehouse_name"), E.col("sm_type"), E.col("cc_name")],
        [
            bucket("d30", lat <= E.lit(30)),
            bucket("d31_60", (lat > E.lit(30)) & (lat <= E.lit(60))),
            bucket("d61_90", (lat > E.lit(60)) & (lat <= E.lit(90))),
            bucket("d91_120", (lat > E.lit(90)) & (lat <= E.lit(120))),
            bucket("d120p", lat > E.lit(120)),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("w_warehouse_name")), E.SortOrder(E.col("sm_type")),
         E.SortOrder(E.col("cc_name"))],
        fetch=100,
    )


def q65(max_groups: int = 1 << 16) -> P.PlanNode:
    """Store-item revenue at most 10% of the store's average item revenue."""
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(24, 35))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    per_item = j.aggregate(
        [E.col("ss_store_sk"), E.col("ss_item_sk")],
        [E.AggExpr("sum", E.col("ss_sales_price"), "revenue")],
    )
    per_item.max_groups = max_groups
    per_store = per_item.aggregate(
        [E.col("ss_store_sk").alias("sb_store_sk")],
        [E.AggExpr("avg", E.col("revenue"), "ave")],
    )
    per_store.max_groups = 64
    j2 = _j(per_item, per_store, ["ss_store_sk"], ["sb_store_sk"],
            cond=E.col("revenue").cast(T.FLOAT64) <= E.lit(0.1) * E.col("ave").cast(T.FLOAT64))
    j2 = _j(j2, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j2 = _j(j2, _scan("item"), ["ss_item_sk"], ["i_item_sk"])
    return j2.project(
        [E.col("s_store_name"), E.col("i_item_desc"), E.col("revenue"),
         E.col("i_current_price")]
    ).sort(
        [E.SortOrder(E.col("s_store_name")), E.SortOrder(E.col("i_item_desc"))],
        fetch=100,
    )


def _ticket_query(date_pred, hd_pred, max_groups, cnt_lo, cnt_hi):
    dt = _scan("date_dim").filter(date_pred)
    hd = _scan("household_demographics").filter(hd_pred)
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, hd, ["ss_hdemo_sk"], ["hd_demo_sk"])
    per = j.aggregate(
        [E.col("ss_ticket_number"), E.col("ss_customer_sk")],
        [E.AggExpr("count", None, "cnt")],
    )
    per.max_groups = max_groups
    filt = P.Filter(per, E.col("cnt").between(cnt_lo, cnt_hi))
    j2 = _j(filt, _scan("customer"), ["ss_customer_sk"], ["c_customer_sk"])
    return j2.sort(
        [E.SortOrder(E.col("cnt"), ascending=False), E.SortOrder(E.col("c_last_name")),
         E.SortOrder(E.col("ss_ticket_number"))]
    ).project(
        [E.col("c_last_name"), E.col("c_first_name"), E.col("c_salutation"),
         E.col("c_preferred_cust_flag"), E.col("ss_ticket_number"), E.col("cnt")]
    )


def q73(max_groups: int = 1 << 16) -> P.PlanNode:
    """Tickets with 1-5 items for high-dependency households."""
    return _ticket_query(
        (E.col("d_dom").between(1, 2)) & E.col("d_year").isin(1999, 2000, 2001),
        E.col("hd_buy_potential").isin(">10000", "Unknown")
        & (E.col("hd_vehicle_count") > 0)
        & (
            E.col("hd_dep_count").cast(T.FLOAT64)
            / E.CaseWhen(((E.col("hd_vehicle_count") > 0, E.col("hd_vehicle_count")),), E.lit(1)).cast(T.FLOAT64)
            > E.lit(1.0)
        ),
        max_groups, 1, 5,
    )


def q79(max_groups: int = 1 << 16) -> P.PlanNode:
    """Monday shoppers with many dependents or vehicles, by store city."""
    dt = _scan("date_dim").filter((E.col("d_dow") == E.lit(1)) & E.col("d_year").isin(1999, 2000, 2001))
    hd = _scan("household_demographics").filter(
        (E.col("hd_dep_count") == E.lit(6)) | (E.col("hd_vehicle_count") > E.lit(2))
    )
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, hd, ["ss_hdemo_sk"], ["hd_demo_sk"])
    per = j.aggregate(
        [E.col("ss_ticket_number"), E.col("ss_customer_sk"), E.col("s_city")],
        [
            E.AggExpr("sum", E.col("ss_coupon_amt"), "amt"),
            E.AggExpr("sum", E.col("ss_net_profit"), "profit"),
        ],
    )
    per.max_groups = max_groups
    j2 = _j(per, _scan("customer"), ["ss_customer_sk"], ["c_customer_sk"])
    return j2.sort(
        [E.SortOrder(E.col("c_last_name")), E.SortOrder(E.col("c_first_name")),
         E.SortOrder(E.col("s_city")), E.SortOrder(E.col("profit")),
         E.SortOrder(E.col("ss_ticket_number"))],
        fetch=100,
    ).project(
        [E.col("c_last_name"), E.col("c_first_name"), E.col("s_city"),
         E.col("ss_ticket_number"), E.col("amt"), E.col("profit")]
    )


def q68(max_groups: int = 1 << 16) -> P.PlanNode:
    """Ticket extended amounts for two cities; buyer now lives elsewhere."""
    dt = _scan("date_dim").filter(
        (E.col("d_dom").between(1, 2)) & E.col("d_year").isin(1999, 2000, 2001)
    )
    hd = _scan("household_demographics").filter(
        (E.col("hd_dep_count") == E.lit(5)) | (E.col("hd_vehicle_count") == E.lit(3))
    )
    ca = _scan("customer_address").filter(E.col("ca_city").isin("city0", "city1"))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, hd, ["ss_hdemo_sk"], ["hd_demo_sk"])
    j = _j(j, ca, ["ss_addr_sk"], ["ca_address_sk"])
    per = j.aggregate(
        [E.col("ss_ticket_number"), E.col("ss_customer_sk"), E.col("ca_city").alias("bought_city")],
        [
            E.AggExpr("sum", E.col("ss_ext_sales_price"), "extended_price"),
            E.AggExpr("sum", E.col("ss_ext_wholesale_cost"), "extended_cost"),
        ],
    )
    per.max_groups = max_groups
    j2 = _j(per, _scan("customer"), ["ss_customer_sk"], ["c_customer_sk"])
    cur = _scan("customer_address").project(
        [E.col("ca_address_sk").alias("cur_addr_sk"), E.col("ca_city").alias("cur_city")]
    )
    j3 = _j(j2, cur, ["c_current_addr_sk"], ["cur_addr_sk"],
            cond=E.col("cur_city") != E.col("bought_city"))
    return j3.sort(
        [E.SortOrder(E.col("c_last_name")), E.SortOrder(E.col("ss_ticket_number"))],
        fetch=100,
    ).project(
        [E.col("c_last_name"), E.col("c_first_name"), E.col("bought_city"),
         E.col("ss_ticket_number"), E.col("extended_price"), E.col("extended_cost")]
    )


def q96(max_groups: int = 8) -> P.PlanNode:
    """COUNT(*) of evening sales for dep_count-5 households at one store."""
    td = _scan("time_dim").filter(
        (E.col("t_hour") == E.lit(20)) & (E.col("t_minute") >= E.lit(30))
    )
    hd = _scan("household_demographics").filter(E.col("hd_dep_count") == E.lit(5))
    st = _scan("store").filter(E.col("s_store_name") == E.lit("store_0"))
    j = _j(_scan("store_sales"), hd, ["ss_hdemo_sk"], ["hd_demo_sk"])
    j = _j(j, td, ["ss_sold_time_sk"], ["t_time_sk"])
    j = _j(j, st, ["ss_store_sk"], ["s_store_sk"])
    agg = j.aggregate([], [E.AggExpr("count", None, "cnt")])
    agg.max_groups = max_groups
    return agg


def q25(max_groups: int = 1 << 16) -> P.PlanNode:
    """3-channel profit: store sale in April 2000, returned within 6 months,
    re-bought on catalog by the same customer.

    The (customer,item) catalog join is pre-aggregated to (sum, count) and
    the other side's sums are count-weighted — the algebraically-equivalent
    join-aggregation decomposition that bounds the fan-out of the Zipf-skewed
    many-to-many join (the static-shape analog of AQE skew handling;
    reference: CometShuffleExchangeExec participates in AQE skew splitting)."""
    d1 = _scan("date_dim").filter((E.col("d_moy") == E.lit(4)) & (E.col("d_year") == E.lit(2000))).project(
        [E.col("d_date_sk").alias("d1_sk")]
    )
    d2 = _scan("date_dim").filter(
        E.col("d_moy").between(4, 10) & (E.col("d_year") == E.lit(2000))
    ).project([E.col("d_date_sk").alias("d2_sk")])
    d3 = _scan("date_dim").filter(
        E.col("d_moy").between(4, 10) & (E.col("d_year") == E.lit(2000))
    ).project([E.col("d_date_sk").alias("d3_sk")])
    cs = _j(_scan("catalog_sales"), d3, ["cs_sold_date_sk"], ["d3_sk"])
    cs_agg = cs.aggregate(
        [E.col("cs_bill_customer_sk"), E.col("cs_item_sk")],
        [
            E.AggExpr("sum", E.col("cs_net_profit"), "cs_profit_sum"),
            E.AggExpr("count", None, "cs_cnt"),
        ],
    )
    cs_agg.max_groups = max_groups
    j = P.HashJoin(
        _scan("store_sales"), _scan("store_returns"),
        (E.col("ss_customer_sk"), E.col("ss_item_sk"), E.col("ss_ticket_number")),
        (E.col("sr_customer_sk"), E.col("sr_item_sk"), E.col("sr_ticket_number")),
        P.JoinType.INNER, "right",
    )
    j = _j(j, d1, ["ss_sold_date_sk"], ["d1_sk"])
    j = _j(j, d2, ["sr_returned_date_sk"], ["d2_sk"])
    j = P.HashJoin(
        j, cs_agg,
        (E.col("ss_customer_sk"), E.col("ss_item_sk")),
        (E.col("cs_bill_customer_sk"), E.col("cs_item_sk")),
        P.JoinType.INNER, "right",
    )
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, _scan("item"), ["ss_item_sk"], ["i_item_sk"])
    agg = j.aggregate(
        [E.col("i_item_id"), E.col("i_item_desc"), E.col("s_store_id"), E.col("s_store_name")],
        [
            E.AggExpr("sum", E.col("ss_net_profit") * E.col("cs_cnt"), "store_sales_profit"),
            E.AggExpr("sum", E.col("sr_return_amt") * E.col("cs_cnt"), "store_returns_loss"),
            E.AggExpr("sum", E.col("cs_profit_sum"), "catalog_sales_profit"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("i_item_id")), E.SortOrder(E.col("i_item_desc")),
         E.SortOrder(E.col("s_store_id")), E.SortOrder(E.col("s_store_name"))],
        fetch=100,
    )


def q26(max_groups: int = 1 << 12) -> P.PlanNode:
    """Catalog q7: average sales metrics per item for a demographic +
    promotion slice."""
    cd = _scan("customer_demographics").filter(
        (E.col("cd_gender") == E.lit("M"))
        & (E.col("cd_marital_status") == E.lit("S"))
        & (E.col("cd_education_status") == E.lit("College"))
    )
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2000))
    pr = _scan("promotion").filter(
        (E.col("p_channel_email") == E.lit("N")) | (E.col("p_channel_event") == E.lit("N"))
    )
    j = _j(_scan("catalog_sales"), cd, ["cs_cdemo_sk"], ["cd_demo_sk"])
    j = _j(j, dt, ["cs_sold_date_sk"], ["d_date_sk"])
    j = _j(j, pr, ["cs_promo_sk"], ["p_promo_sk"])
    j = _j(j, _scan("item"), ["cs_item_sk"], ["i_item_sk"])
    agg = j.aggregate(
        [E.col("i_item_id")],
        [
            E.AggExpr("avg", E.col("cs_quantity"), "agg1"),
            E.AggExpr("avg", E.col("cs_list_price"), "agg2"),
            E.AggExpr("avg", E.col("cs_coupon_amt"), "agg3"),
            E.AggExpr("avg", E.col("cs_sales_price"), "agg4"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort([E.SortOrder(E.col("i_item_id"))], fetch=100)


def q45(max_groups: int = 1 << 12) -> P.PlanNode:
    """Web sales by customer zip/city in a quarter, for a zip shortlist or a
    shortlist of items (q45 shape)."""
    dt = _scan("date_dim").filter((E.col("d_qoy") == E.lit(2)) & (E.col("d_year") == E.lit(2000)))
    j = _j(_scan("web_sales"), _scan("customer"), ["ws_bill_customer_sk"], ["c_customer_sk"])
    j = _j(j, _scan("customer_address"), ["c_current_addr_sk"], ["ca_address_sk"])
    j = _j(j, _scan("item"), ["ws_item_sk"], ["i_item_sk"])
    j = _j(j, dt, ["ws_sold_date_sk"], ["d_date_sk"])
    zips = ("85669", "86197", "88274", "83405", "86475")
    cond = (
        E.StringFunc("substring", (E.col("ca_zip"), E.lit(1), E.lit(5))).isin(*zips)
        | E.col("i_item_sk").isin(2, 3, 5, 7, 11, 13, 17, 19, 23, 29)
    )
    agg = P.Filter(j, cond).aggregate(
        [E.col("ca_zip"), E.col("ca_city")],
        [E.AggExpr("sum", E.col("ws_sales_price"), "total")],
    )
    agg.max_groups = max_groups
    return agg.sort([E.SortOrder(E.col("ca_zip")), E.SortOrder(E.col("ca_city"))], fetch=100)


def q60(max_groups: int = 1 << 12) -> P.PlanNode:
    """3-channel item revenue for one category and GMT offset, channels
    unioned then re-aggregated by item id (q60 shape)."""
    def channel(fact, item_col, cust_col, date_col, price_col):
        dt = _scan("date_dim").filter((E.col("d_year") == E.lit(2000)) & (E.col("d_moy") == E.lit(9)))
        it = _scan("item").filter(E.col("i_category") == E.lit("Music"))
        ca = _scan("customer_address").filter(E.col("ca_gmt_offset") == E.lit(-6))
        j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        j = _j(j, it, [item_col], ["i_item_sk"])
        j = _j(j, _scan("customer"), [cust_col], ["c_customer_sk"])
        j = _j(j, ca, ["c_current_addr_sk"], ["ca_address_sk"])
        agg = j.aggregate(
            [E.col("i_item_id")], [E.AggExpr("sum", E.col(price_col), "total_sales")]
        )
        agg.max_groups = max_groups
        return agg

    u = P.Union((
        channel("store_sales", "ss_item_sk", "ss_customer_sk", "ss_sold_date_sk", "ss_ext_sales_price"),
        channel("catalog_sales", "cs_item_sk", "cs_bill_customer_sk", "cs_sold_date_sk", "cs_ext_sales_price"),
        channel("web_sales", "ws_item_sk", "ws_bill_customer_sk", "ws_sold_date_sk", "ws_ext_sales_price"),
    ))
    total = u.aggregate(
        [E.col("i_item_id")], [E.AggExpr("sum", E.col("total_sales"), "total_sales")]
    )
    total.max_groups = max_groups
    return total.sort(
        [E.SortOrder(E.col("i_item_id")), E.SortOrder(E.col("total_sales"))], fetch=100
    )


# ---------------------------------------------------------------------------
# ROLLUP family (reference: grouping sets lowered through CometExpandExec —
# spark/src/main/scala/org/apache/comet/serde operator Expand; each level
# nulls out a suffix of the keys and tags the row with its level)
# ---------------------------------------------------------------------------


def _rollup(child: P.PlanNode, keys, payloads, tag: str = "lochierarchy") -> P.PlanNode:
    """ROLLUP(keys...) via Expand: level L nulls the last L keys; ``tag``
    is the grouping level (0 = full detail .. len(keys) = grand total),
    matching Spark's grouping(a)+grouping(b) lochierarchy convention."""
    n = len(keys)
    projs = []
    for lvl in range(n + 1):
        row = [E.col(k) if i < n - lvl else E.lit(None, dt) for i, (k, dt) in enumerate(keys)]
        row.append(E.lit(lvl))
        row += [E.col(p) for p in payloads]
        projs.append(tuple(row))
    names = tuple(k for k, _ in keys) + (tag,) + tuple(payloads)
    return P.Expand(child, tuple(projs), names)


def q27(max_groups: int = 1 << 16) -> P.PlanNode:
    """Demographic item averages with rollup(i_item_id, s_state)."""
    cd = _scan("customer_demographics").filter(
        (E.col("cd_gender") == E.lit("M")) & (E.col("cd_marital_status") == E.lit("S"))
        & (E.col("cd_education_status") == E.lit("College"))
    )
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2000))
    st = _scan("store").filter(E.col("s_state").isin("TN", "CA"))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, st, ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, cd, ["ss_cdemo_sk"], ["cd_demo_sk"])
    j = _j(j, _scan("item"), ["ss_item_sk"], ["i_item_sk"])
    r = _rollup(j, [("i_item_id", T.string(16)), ("s_state", T.string(2))],
                ["ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price"])
    agg = r.aggregate(
        [E.col("i_item_id"), E.col("s_state"), E.col("lochierarchy")],
        [
            E.AggExpr("avg", E.col("ss_quantity"), "agg1"),
            E.AggExpr("avg", E.col("ss_list_price"), "agg2"),
            E.AggExpr("avg", E.col("ss_coupon_amt"), "agg3"),
            E.AggExpr("avg", E.col("ss_sales_price"), "agg4"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("i_item_id")), E.SortOrder(E.col("s_state"))], fetch=100
    )


def q18(max_groups: int = 1 << 16) -> P.PlanNode:
    """Catalog demographic averages with rollup(i_item_id, ca_state, ca_county)."""
    cd = _scan("customer_demographics").filter(
        (E.col("cd_gender") == E.lit("F")) & (E.col("cd_education_status") == E.lit("Unknown"))
    )
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(1998))
    c = _scan("customer").filter(E.col("c_birth_year").between(1950, 1980))
    ca = _scan("customer_address").filter(E.col("ca_state").isin("CA", "NY", "TX"))
    j = _j(_scan("catalog_sales"), dt, ["cs_sold_date_sk"], ["d_date_sk"])
    j = _j(j, cd, ["cs_cdemo_sk"], ["cd_demo_sk"])
    j = _j(j, c, ["cs_bill_customer_sk"], ["c_customer_sk"])
    j = _j(j, ca, ["c_current_addr_sk"], ["ca_address_sk"])
    j = _j(j, _scan("item"), ["cs_item_sk"], ["i_item_sk"])
    r = _rollup(
        j,
        [("i_item_id", T.string(16)), ("ca_state", T.string(2)), ("ca_county", T.string(20))],
        ["cs_quantity", "cs_list_price", "cs_coupon_amt", "cs_sales_price",
         "cs_net_profit", "c_birth_year", "cd_dep_count"],
    )
    agg = r.aggregate(
        [E.col("i_item_id"), E.col("ca_state"), E.col("ca_county"), E.col("lochierarchy")],
        [
            E.AggExpr("avg", E.col("cs_quantity").cast(T.FLOAT64), "agg1"),
            E.AggExpr("avg", E.col("cs_list_price").cast(T.FLOAT64), "agg2"),
            E.AggExpr("avg", E.col("cs_coupon_amt").cast(T.FLOAT64), "agg3"),
            E.AggExpr("avg", E.col("cs_sales_price").cast(T.FLOAT64), "agg4"),
            E.AggExpr("avg", E.col("cs_net_profit").cast(T.FLOAT64), "agg5"),
            E.AggExpr("avg", E.col("c_birth_year").cast(T.FLOAT64), "agg6"),
            E.AggExpr("avg", E.col("cd_dep_count").cast(T.FLOAT64), "agg7"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("ca_county")), E.SortOrder(E.col("ca_state")),
         E.SortOrder(E.col("i_item_id"))],
        fetch=100,
    )


def q22(max_groups: int = 1 << 16) -> P.PlanNode:
    """Inventory quantity-on-hand averages, 4-level item rollup."""
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(12, 23))
    j = _j(_scan("inventory"), dt, ["inv_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("item"), ["inv_item_sk"], ["i_item_sk"])
    r = _rollup(
        j,
        [("i_product_name", T.string(24)), ("i_brand", T.string(30)),
         ("i_class", T.string(12)), ("i_category", T.string(12))],
        ["inv_quantity_on_hand"],
    )
    agg = r.aggregate(
        [E.col("i_product_name"), E.col("i_brand"), E.col("i_class"),
         E.col("i_category"), E.col("lochierarchy")],
        [E.AggExpr("avg", E.col("inv_quantity_on_hand"), "qoh")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("qoh")), E.SortOrder(E.col("i_product_name")),
         E.SortOrder(E.col("i_brand")), E.SortOrder(E.col("i_class")),
         E.SortOrder(E.col("i_category"))],
        fetch=100,
    )


# ---------------------------------------------------------------------------
# Multi-channel UNION family (reference: CometUnionExec over per-channel
# subplans; returns folded in through pre-aggregated left joins so the
# static-shape fan-out stays bounded)
# ---------------------------------------------------------------------------


def _manufact_channel(fact: str, date_col: str, item_col: str, addr_col: str,
                      price_col: str, group_col: str, item_pred) -> P.PlanNode:
    """One q33/q56/q60 channel: date + gmt-offset + item-attribute filter,
    grouped revenue."""
    dt = _scan("date_dim").filter((E.col("d_year") == E.lit(1998)) & (E.col("d_moy") == E.lit(5)))
    ca = _scan("customer_address").filter(E.col("ca_gmt_offset") == E.lit(-5))
    it = _scan("item").filter(item_pred)
    j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
    j = _j(j, ca, [addr_col], ["ca_address_sk"])
    j = _j(j, it, [item_col], ["i_item_sk"])
    agg = j.aggregate([E.col(group_col)], [E.AggExpr("sum", E.col(price_col), "total_sales")])
    agg.max_groups = 1 << 12
    return agg


def _three_channel_total(group_col: str, item_pred, max_groups: int) -> P.PlanNode:
    u = P.Union((
        _manufact_channel("store_sales", "ss_sold_date_sk", "ss_item_sk",
                          "ss_addr_sk", "ss_ext_sales_price", group_col, item_pred),
        _manufact_channel("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                          "cs_ship_addr_sk", "cs_ext_sales_price", group_col, item_pred),
        _manufact_channel("web_sales", "ws_sold_date_sk", "ws_item_sk",
                          "ws_ship_addr_sk", "ws_ext_sales_price", group_col, item_pred),
    ))
    agg = u.aggregate([E.col(group_col)], [E.AggExpr("sum", E.col("total_sales"), "total_sales")])
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("total_sales")), E.SortOrder(E.col(group_col))], fetch=100
    )


def q33(max_groups: int = 1 << 12) -> P.PlanNode:
    """Manufacturer revenue across all three channels (Electronics)."""
    return _three_channel_total(
        "i_manufact_id", E.col("i_category") == E.lit("Electronics"), max_groups)


def q56(max_groups: int = 1 << 12) -> P.PlanNode:
    """Item revenue across all three channels for selected colors."""
    return _three_channel_total(
        "i_item_id", E.col("i_color").isin("navy", "olive", "plum"), max_groups)


def q71(max_groups: int = 1 << 14) -> P.PlanNode:
    """Brand revenue by hour/minute over three channels (manager 1)."""
    dt = _scan("date_dim").filter((E.col("d_year") == E.lit(1999)) & (E.col("d_moy") == E.lit(11)))
    it = _scan("item").filter(E.col("i_manager_id") == E.lit(1))
    td = _scan("time_dim").filter(E.col("t_hour").isin(8, 9, 17, 18))

    def chan(fact, date_col, item_col, time_col, price_col):
        j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        return j.project([E.col(price_col).alias("ext_price"),
                          E.col(item_col).alias("sold_item_sk"),
                          E.col(time_col).alias("time_sk")])

    u = P.Union((
        chan("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_sold_time_sk", "ws_ext_sales_price"),
        chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_sold_time_sk", "cs_ext_sales_price"),
        chan("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_sold_time_sk", "ss_ext_sales_price"),
    ))
    j = _j(u, it, ["sold_item_sk"], ["i_item_sk"])
    j = _j(j, td, ["time_sk"], ["t_time_sk"])
    agg = j.aggregate(
        [E.col("i_brand_id"), E.col("i_brand"), E.col("t_hour"), E.col("t_minute")],
        [E.AggExpr("sum", E.col("ext_price"), "ext_price")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("ext_price"), ascending=False), E.SortOrder(E.col("i_brand_id")),
         E.SortOrder(E.col("t_hour")), E.SortOrder(E.col("t_minute"))],
        fetch=100,
    )


def _returns_agg(fact: str, keys, amount_cols, out_names, max_groups: int = 1 << 16):
    """Pre-aggregate a returns table by join keys (bounds many-to-many
    fan-out; the oracle mirrors the same decomposition)."""
    agg = _scan(fact).aggregate(
        [E.col(k) for k in keys],
        [E.AggExpr("sum", E.col(c), o) for c, o in zip(amount_cols, out_names)],
    )
    agg.max_groups = max_groups
    return agg


def q5(max_groups: int = 1 << 14) -> P.PlanNode:
    """Channel/id sales-vs-returns profile with rollup(channel, id)."""
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(12, 13))

    def sales_part(fact, date_col, id_join, id_scan, id_key, id_out, sales_col, profit_col):
        j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        j = _j(j, _scan(id_scan), [id_join], [id_key])
        return j.project([
            E.col(id_out).alias("id"),
            E.col(sales_col).cast(T.decimal(17, 2)).alias("sales"),
            E.lit(0).cast(T.decimal(17, 2)).alias("returns_amt"),
            E.col(profit_col).cast(T.decimal(17, 2)).alias("profit"),
            E.lit(0).cast(T.decimal(17, 2)).alias("profit_loss"),
        ])

    def returns_part(fact, date_col, id_join, id_scan, id_key, id_out, ret_col, loss_col):
        j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        j = _j(j, _scan(id_scan), [id_join], [id_key])
        return j.project([
            E.col(id_out).alias("id"),
            E.lit(0).cast(T.decimal(17, 2)).alias("sales"),
            E.col(ret_col).cast(T.decimal(17, 2)).alias("returns_amt"),
            E.lit(0).cast(T.decimal(17, 2)).alias("profit"),
            E.col(loss_col).cast(T.decimal(17, 2)).alias("profit_loss"),
        ])

    def channel(name, sales, returns):
        u = P.Union((sales, returns))
        return P.Projection(u, (
            E.lit(name).alias("channel"), E.col("id"), E.col("sales"),
            E.col("returns_amt"), E.col("profit"), E.col("profit_loss"),
        ))

    store = channel(
        "store channel",
        sales_part("store_sales", "ss_sold_date_sk", "ss_store_sk", "store",
                   "s_store_sk", "s_store_id", "ss_ext_sales_price", "ss_net_profit"),
        returns_part("store_returns", "sr_returned_date_sk", "sr_store_sk", "store",
                     "s_store_sk", "s_store_id", "sr_return_amt", "sr_net_loss"),
    )
    catalog = channel(
        "catalog channel",
        sales_part("catalog_sales", "cs_sold_date_sk", "cs_catalog_page_sk", "catalog_page",
                   "cp_catalog_page_sk", "cp_catalog_page_id", "cs_ext_sales_price", "cs_net_profit"),
        returns_part("catalog_returns", "cr_returned_date_sk", "cr_catalog_page_sk", "catalog_page",
                     "cp_catalog_page_sk", "cp_catalog_page_id", "cr_return_amount", "cr_net_loss"),
    )
    # web returns reach web_site through the originating sale (spec: wr LEFT
    # OUTER JOIN ws on item+order); pre-aggregate wr per (item, order) first
    wrf = _j(_scan("web_returns"), dt, ["wr_returned_date_sk"], ["d_date_sk"])
    wr = wrf.aggregate(
        [E.col("wr_item_sk"), E.col("wr_order_number")],
        [E.AggExpr("sum", E.col("wr_return_amt"), "ret_amt"),
         E.AggExpr("sum", E.col("wr_net_loss"), "ret_loss")],
    )
    wr.max_groups = 1 << 16
    ws_sk = _scan("web_sales").aggregate(
        [E.col("ws_item_sk"), E.col("ws_order_number"), E.col("ws_web_site_sk")],
        [E.AggExpr("count", None, "n_sales")],
    )
    ws_sk.max_groups = 1 << 16
    wrj = P.HashJoin(wr, ws_sk, (E.col("wr_item_sk"), E.col("wr_order_number")),
                     (E.col("ws_item_sk"), E.col("ws_order_number")), P.JoinType.INNER, "right")
    wr_dated = _j(wrj, _scan("web_site"), ["ws_web_site_sk"], ["web_site_sk"]).project([
        E.col("web_name").alias("id"),
        E.lit(0).cast(T.decimal(17, 2)).alias("sales"),
        E.col("ret_amt").cast(T.decimal(17, 2)).alias("returns_amt"),
        E.lit(0).cast(T.decimal(17, 2)).alias("profit"),
        E.col("ret_loss").cast(T.decimal(17, 2)).alias("profit_loss"),
    ])
    web = channel(
        "web channel",
        sales_part("web_sales", "ws_sold_date_sk", "ws_web_site_sk", "web_site",
                   "web_site_sk", "web_name", "ws_ext_sales_price", "ws_net_profit"),
        wr_dated,
    )
    u = P.Union((store, catalog, web))
    r = _rollup(u, [("channel", T.string(16)), ("id", T.string(20))],
                ["sales", "returns_amt", "profit", "profit_loss"])
    agg = r.aggregate(
        [E.col("channel"), E.col("id"), E.col("lochierarchy")],
        [
            E.AggExpr("sum", E.col("sales"), "sales"),
            E.AggExpr("sum", E.col("returns_amt"), "returns_amt"),
            E.AggExpr("sum", E.col("profit") - E.col("profit_loss"), "profit"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("channel")), E.SortOrder(E.col("id"))], fetch=100
    )


def q75(max_groups: int = 1 << 16) -> P.PlanNode:
    """Year-over-year net-of-returns quantity/amount by item attributes;
    categories whose current-year quantity fell below 90% of prior year."""
    dt = _scan("date_dim")

    def chan(fact, date_col, item_col, qty_col, price_col, rfact, rkeys, fkeys,
             rqty, ramt):
        r = _returns_agg(rfact, rkeys, [rqty, ramt], ["r_qty", "r_amt"])
        j = P.HashJoin(_scan(fact), r,
                       tuple(E.col(k) for k in fkeys),
                       tuple(E.col(k) for k in rkeys), P.JoinType.LEFT, "right")
        j = _j(j, dt, [date_col], ["d_date_sk"])
        j = _j(j, _scan("item").filter(E.col("i_category") == E.lit("Books")),
               [item_col], ["i_item_sk"])
        return j.project([
            E.col("d_year"), E.col("i_brand_id"), E.col("i_class"),
            E.col("i_category"), E.col("i_manufact_id"),
            (E.col(qty_col) - E.coalesce(E.col("r_qty"), E.lit(0))).alias("sales_cnt"),
            (E.col(price_col).cast(T.decimal(17, 2))
             - E.coalesce(E.col("r_amt").cast(T.decimal(17, 2)),
                          E.lit(0).cast(T.decimal(17, 2)))).alias("sales_amt"),
        ])

    u = P.Union((
        chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_quantity",
             "cs_ext_sales_price", "catalog_returns",
             ["cr_item_sk", "cr_order_number"], ["cs_item_sk", "cs_order_number"],
             "cr_return_quantity", "cr_return_amount"),
        chan("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_quantity",
             "ss_ext_sales_price", "store_returns",
             ["sr_item_sk", "sr_ticket_number"], ["ss_item_sk", "ss_ticket_number"],
             "sr_return_quantity", "sr_return_amt"),
        chan("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_quantity",
             "ws_ext_sales_price", "web_returns",
             ["wr_item_sk", "wr_order_number"], ["ws_item_sk", "ws_order_number"],
             "wr_return_quantity", "wr_return_amt"),
    ))
    agg = u.aggregate(
        [E.col("d_year"), E.col("i_brand_id"), E.col("i_class"),
         E.col("i_category"), E.col("i_manufact_id")],
        [E.AggExpr("sum", E.col("sales_cnt"), "sales_cnt"),
         E.AggExpr("sum", E.col("sales_amt"), "sales_amt")],
    )
    agg.max_groups = max_groups
    curr = agg.filter(E.col("d_year") == E.lit(2000)).project(
        [E.col("i_brand_id").alias("c_brand"), E.col("i_class").alias("c_class"),
         E.col("i_category").alias("c_cat"), E.col("i_manufact_id").alias("c_man"),
         E.col("sales_cnt").alias("curr_cnt"), E.col("sales_amt").alias("curr_amt")]
    )
    prev = agg.filter(E.col("d_year") == E.lit(1999)).project(
        [E.col("i_brand_id").alias("p_brand"), E.col("i_class").alias("p_class"),
         E.col("i_category").alias("p_cat"), E.col("i_manufact_id").alias("p_man"),
         E.col("sales_cnt").alias("prev_cnt"), E.col("sales_amt").alias("prev_amt")]
    )
    j = P.HashJoin(
        curr, prev,
        (E.col("c_brand"), E.col("c_class"), E.col("c_cat"), E.col("c_man")),
        (E.col("p_brand"), E.col("p_class"), E.col("p_cat"), E.col("p_man")),
        P.JoinType.INNER, "right",
    )
    keep = j.filter(
        (E.col("prev_cnt") > E.lit(0))
        & (E.col("curr_cnt").cast(T.FLOAT64) / E.col("prev_cnt").cast(T.FLOAT64)
           < E.lit(0.9))
    )
    return keep.sort(
        [E.SortOrder(E.col("curr_cnt") - E.col("prev_cnt")),
         E.SortOrder(E.col("c_brand")), E.SortOrder(E.col("c_class")),
         E.SortOrder(E.col("c_man"))],
        fetch=100,
    )


def q76(max_groups: int = 1 << 14) -> P.PlanNode:
    """Channel sales profile union (adaptation: the reference counts rows
    with NULL channel FKs; generated data has no nulls, so each channel
    restricts on a small FK band instead — same union + count/sum shape)."""
    dt = _scan("date_dim")
    it = _scan("item")

    def chan(name, col_name, fact, pred, item_col, date_col, price_col):
        j = _scan(fact).filter(pred)
        j = _j(j, it, [item_col], ["i_item_sk"])
        j = _j(j, dt, [date_col], ["d_date_sk"])
        return j.project([
            E.lit(name).alias("channel"), E.lit(col_name).alias("col_name"),
            E.col("d_year"), E.col("d_qoy"), E.col("i_category"),
            E.col(price_col).alias("ext_sales_price"),
        ])

    u = P.Union((
        chan("store", "ss_hdemo_sk", "store_sales",
             E.col("ss_hdemo_sk") <= E.lit(10), "ss_item_sk", "ss_sold_date_sk",
             "ss_ext_sales_price"),
        chan("web", "ws_ship_mode_sk", "web_sales",
             E.col("ws_ship_mode_sk") == E.lit(1), "ws_item_sk", "ws_sold_date_sk",
             "ws_ext_sales_price"),
        chan("catalog", "cs_warehouse_sk", "catalog_sales",
             E.col("cs_warehouse_sk") == E.lit(1), "cs_item_sk", "cs_sold_date_sk",
             "cs_ext_sales_price"),
    ))
    agg = u.aggregate(
        [E.col("channel"), E.col("col_name"), E.col("d_year"), E.col("d_qoy"),
         E.col("i_category")],
        [E.AggExpr("count", None, "sales_cnt"),
         E.AggExpr("sum", E.col("ext_sales_price"), "sales_amt")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("channel")), E.SortOrder(E.col("col_name")),
         E.SortOrder(E.col("d_year")), E.SortOrder(E.col("d_qoy")),
         E.SortOrder(E.col("i_category"))],
        fetch=100,
    )


def q80(max_groups: int = 1 << 14) -> P.PlanNode:
    """Channel sales/returns/profit rollup over promoted high-price items."""
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(12, 13))
    it = _scan("item").filter(E.col("i_current_price") > E.lit(50, T.decimal(7, 2)))
    pr = _scan("promotion").filter(E.col("p_channel_tv") == E.lit("N"))

    def chan(name, fact, date_col, item_col, promo_col, id_join, id_scan, id_key,
             id_out, sales_col, profit_col, rfact, rkeys, fkeys, ramt, rloss):
        r = _returns_agg(rfact, rkeys, [ramt, rloss], ["r_amt", "r_loss"])
        j = P.HashJoin(_scan(fact), r,
                       tuple(E.col(k) for k in fkeys),
                       tuple(E.col(k) for k in rkeys), P.JoinType.LEFT, "right")
        j = _j(j, dt, [date_col], ["d_date_sk"])
        j = _j(j, it, [item_col], ["i_item_sk"])
        j = _j(j, pr, [promo_col], ["p_promo_sk"])
        j = _j(j, _scan(id_scan), [id_join], [id_key])
        return j.project([
            E.lit(name).alias("channel"), E.col(id_out).alias("id"),
            E.col(sales_col).cast(T.decimal(17, 2)).alias("sales"),
            E.coalesce(E.col("r_amt").cast(T.decimal(17, 2)),
                       E.lit(0).cast(T.decimal(17, 2))).alias("returns_amt"),
            (E.col(profit_col).cast(T.decimal(17, 2))
             - E.coalesce(E.col("r_loss").cast(T.decimal(17, 2)),
                          E.lit(0).cast(T.decimal(17, 2)))).alias("profit"),
        ])

    u = P.Union((
        chan("store channel", "store_sales", "ss_sold_date_sk", "ss_item_sk",
             "ss_promo_sk", "ss_store_sk", "store", "s_store_sk", "s_store_id",
             "ss_ext_sales_price", "ss_net_profit", "store_returns",
             ["sr_item_sk", "sr_ticket_number"], ["ss_item_sk", "ss_ticket_number"],
             "sr_return_amt", "sr_net_loss"),
        chan("catalog channel", "catalog_sales", "cs_sold_date_sk", "cs_item_sk",
             "cs_promo_sk", "cs_catalog_page_sk", "catalog_page",
             "cp_catalog_page_sk", "cp_catalog_page_id",
             "cs_ext_sales_price", "cs_net_profit", "catalog_returns",
             ["cr_item_sk", "cr_order_number"], ["cs_item_sk", "cs_order_number"],
             "cr_return_amount", "cr_net_loss"),
    ))
    r = _rollup(u, [("channel", T.string(16)), ("id", T.string(20))],
                ["sales", "returns_amt", "profit"])
    agg = r.aggregate(
        [E.col("channel"), E.col("id"), E.col("lochierarchy")],
        [E.AggExpr("sum", E.col("sales"), "sales"),
         E.AggExpr("sum", E.col("returns_amt"), "returns_amt"),
         E.AggExpr("sum", E.col("profit"), "profit")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("channel")), E.SortOrder(E.col("id"))], fetch=100
    )


def q97(max_groups: int = 1 << 18) -> P.PlanNode:
    """Store/catalog customer-item overlap via full outer join of the two
    distinct (customer, item) sets."""
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(12, 23))
    ssci = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"]).aggregate(
        [E.col("ss_customer_sk"), E.col("ss_item_sk")], [E.AggExpr("count", None, "n1")]
    )
    ssci.max_groups = max_groups
    csci = _j(_scan("catalog_sales"), dt, ["cs_sold_date_sk"], ["d_date_sk"]).aggregate(
        [E.col("cs_bill_customer_sk"), E.col("cs_item_sk")], [E.AggExpr("count", None, "n2")]
    )
    csci.max_groups = max_groups
    j = P.HashJoin(ssci, csci, (E.col("ss_customer_sk"), E.col("ss_item_sk")),
                   (E.col("cs_bill_customer_sk"), E.col("cs_item_sk")),
                   P.JoinType.FULL, "right")
    return j.aggregate(
        [],
        [
            E.AggExpr("sum", E.if_(E.col("n1").is_not_null() & E.col("n2").is_null(),
                                   E.lit(1), E.lit(0)), "store_only"),
            E.AggExpr("sum", E.if_(E.col("n1").is_null() & E.col("n2").is_not_null(),
                                   E.lit(1), E.lit(0)), "catalog_only"),
            E.AggExpr("sum", E.if_(E.col("n1").is_not_null() & E.col("n2").is_not_null(),
                                   E.lit(1), E.lit(0)), "store_and_catalog"),
        ],
    )


# ---------------------------------------------------------------------------
# Correlated-subquery / semi / anti / existence family. Scalar and
# correlated subqueries lower to pre-aggregated joins; EXISTS/NOT EXISTS
# lower to LEFT_SEMI/LEFT_ANTI/EXISTENCE (reference: planner.rs join-type
# lowering + RewriteJoin; subquery.rs scalar placeholders)
# ---------------------------------------------------------------------------


def _exceeds_group_avg(detail: P.PlanNode, avg_key: str, value_col: str,
                       factor: float, max_groups: int) -> P.PlanNode:
    """Keep detail rows whose ``value_col`` exceeds ``factor`` × the average
    of ``value_col`` over rows sharing ``avg_key`` (the correlated-average
    decorrelation: aggregate once, join back)."""
    avg = detail.aggregate(
        [E.col(avg_key)], [E.AggExpr("avg", E.col(value_col).cast(T.FLOAT64), "grp_avg")]
    )
    avg.max_groups = max_groups
    avg = avg.project([E.col(avg_key).alias("avg_join_key"), E.col("grp_avg")])
    j = P.HashJoin(detail, avg, (E.col(avg_key),), (E.col("avg_join_key"),),
                   P.JoinType.INNER, "right")
    return j.filter(
        E.col(value_col).cast(T.FLOAT64) > E.lit(factor) * E.col("grp_avg")
    )


def q1(max_groups: int = 1 << 16) -> P.PlanNode:
    """Customers returning more than 1.2× their store's average."""
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2000))
    ctr = _j(_scan("store_returns"), dt, ["sr_returned_date_sk"], ["d_date_sk"]).aggregate(
        [E.col("sr_customer_sk"), E.col("sr_store_sk")],
        [E.AggExpr("sum", E.col("sr_return_amt"), "ctr_total_return")],
    )
    ctr.max_groups = max_groups
    keep = _exceeds_group_avg(ctr, "sr_store_sk", "ctr_total_return", 1.2, 64)
    st = _scan("store").filter(E.col("s_state") == E.lit("TN"))
    j = _j(keep, st, ["sr_store_sk"], ["s_store_sk"])
    j = _j(j, _scan("customer"), ["sr_customer_sk"], ["c_customer_sk"])
    return j.project([E.col("c_customer_id")]).sort(
        [E.SortOrder(E.col("c_customer_id"))], fetch=100
    )


def q6(max_groups: int = 1 << 12) -> P.PlanNode:
    """Customer states buying items priced 1.2× above their category average
    in one month (month resolved through a dimension semi-join)."""
    month = _scan("date_dim").filter(
        (E.col("d_year") == E.lit(1999)) & (E.col("d_moy") == E.lit(5))
    ).aggregate([E.col("d_month_seq")], [E.AggExpr("count", None, "n")])
    month.max_groups = 8
    dt = P.HashJoin(_scan("date_dim"), month.project([E.col("d_month_seq").alias("target_seq")]),
                    (E.col("d_month_seq"),), (E.col("target_seq"),),
                    P.JoinType.LEFT_SEMI, "right")
    cat_avg = _scan("item").aggregate(
        [E.col("i_category")],
        [E.AggExpr("avg", E.col("i_current_price").cast(T.FLOAT64), "cat_avg")],
    )
    cat_avg.max_groups = 64
    it = P.HashJoin(_scan("item"), cat_avg.project([E.col("i_category").alias("avg_cat"),
                                                    E.col("cat_avg")]),
                    (E.col("i_category"),), (E.col("avg_cat"),), P.JoinType.INNER, "right")
    it = it.filter(E.col("i_current_price").cast(T.FLOAT64) > E.lit(1.2) * E.col("cat_avg"))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, it, ["ss_item_sk"], ["i_item_sk"])
    j = _j(j, _scan("customer"), ["ss_customer_sk"], ["c_customer_sk"])
    j = _j(j, _scan("customer_address"), ["c_current_addr_sk"], ["ca_address_sk"])
    agg = j.aggregate([E.col("ca_state")], [E.AggExpr("count", None, "cnt")])
    agg.max_groups = max_groups
    return agg.filter(E.col("cnt") >= E.lit(3)).sort(
        [E.SortOrder(E.col("cnt")), E.SortOrder(E.col("ca_state"))], fetch=100
    )


def q8(max_groups: int = 1 << 12) -> P.PlanNode:
    """Store profits in zip prefixes shared with >10-preferred-customer zips."""
    zip5 = E.StringFunc("substring", (E.col("ca_zip"), E.lit(1), E.lit(5)))
    a1 = _scan("customer_address").project([zip5.alias("zip5")]).filter(
        E.StringFunc("substring", (E.col("zip5"), E.lit(1), E.lit(2))).isin(
            *[f"{a}{b}" for a in range(1, 10) for b in range(0, 5)])
    )
    pref = _j(_scan("customer").filter(E.col("c_preferred_cust_flag") == E.lit("Y")),
              _scan("customer_address"), ["c_current_addr_sk"], ["ca_address_sk"])
    a2 = pref.project([zip5.alias("zip5")]).aggregate(
        [E.col("zip5")], [E.AggExpr("count", None, "cnt")]
    )
    # spec threshold is >10 preferred customers per zip; the synthetic
    # generator's address density is far sparser, so default to >2
    a2.max_groups = max_groups
    a2 = a2.filter(E.col("cnt") > E.lit(1)).project([E.col("zip5").alias("zip5b")])
    both = P.HashJoin(a1, a2, (E.col("zip5"),), (E.col("zip5b"),),
                      P.JoinType.LEFT_SEMI, "right")
    zip2 = both.project(
        [E.StringFunc("substring", (E.col("zip5"), E.lit(1), E.lit(2))).alias("zip2")]
    ).aggregate([E.col("zip2")], [E.AggExpr("count", None, "n")])
    zip2.max_groups = 1 << 8
    st = P.HashJoin(
        _scan("store").project(
            [E.col("s_store_sk"), E.col("s_store_name"),
             E.StringFunc("substring", (E.col("s_zip"), E.lit(1), E.lit(2))).alias("s_zip2")]),
        zip2.project([E.col("zip2")]),
        (E.col("s_zip2"),), (E.col("zip2"),), P.JoinType.LEFT_SEMI, "right",
    )
    dt = _scan("date_dim").filter((E.col("d_qoy") == E.lit(2)) & (E.col("d_year") == E.lit(1998)))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, st, ["ss_store_sk"], ["s_store_sk"])
    agg = j.aggregate([E.col("s_store_name")],
                      [E.AggExpr("sum", E.col("ss_net_profit"), "net_profit")])
    agg.max_groups = 64
    return agg.sort([E.SortOrder(E.col("s_store_name"))], fetch=100)


def _active_customers(require_web_or_catalog: str) -> P.PlanNode:
    """Customers with a store purchase in the window and (existence of /
    absence of) web or catalog purchases — the q10/q35/q69 skeleton.
    ``require_web_or_catalog``: 'either' (q10/q35) or 'neither' (q69)."""
    dt = _scan("date_dim").filter(
        (E.col("d_year") == E.lit(1999)) & (E.col("d_moy").between(1, 4))
    )
    ss_c = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"]).aggregate(
        [E.col("ss_customer_sk")], [E.AggExpr("count", None, "n_ss")]
    )
    ss_c.max_groups = 1 << 16
    ws_c = _j(_scan("web_sales"), dt, ["ws_sold_date_sk"], ["d_date_sk"]).aggregate(
        [E.col("ws_bill_customer_sk")], [E.AggExpr("count", None, "n_ws")]
    )
    ws_c.max_groups = 1 << 16
    cs_c = _j(_scan("catalog_sales"), dt, ["cs_sold_date_sk"], ["d_date_sk"]).aggregate(
        [E.col("cs_bill_customer_sk")], [E.AggExpr("count", None, "n_cs")]
    )
    cs_c.max_groups = 1 << 16
    c = P.HashJoin(_scan("customer"), ss_c.project([E.col("ss_customer_sk")]),
                   (E.col("c_customer_sk"),), (E.col("ss_customer_sk"),),
                   P.JoinType.LEFT_SEMI, "right")
    c = P.HashJoin(c, ws_c.project([E.col("ws_bill_customer_sk")]),
                   (E.col("c_customer_sk"),), (E.col("ws_bill_customer_sk"),),
                   P.JoinType.EXISTENCE, "right")
    c = c.project([E.col(f.name) for f in SCHEMAS["customer"].fields]
                  + [E.col("exists").alias("has_ws")])
    c = P.HashJoin(c, cs_c.project([E.col("cs_bill_customer_sk")]),
                   (E.col("c_customer_sk"),), (E.col("cs_bill_customer_sk"),),
                   P.JoinType.EXISTENCE, "right")
    c = c.project([E.col(f.name) for f in SCHEMAS["customer"].fields]
                  + [E.col("has_ws"), E.col("exists").alias("has_cs")])
    if require_web_or_catalog == "either":
        return c.filter(E.col("has_ws") | E.col("has_cs"))
    return c.filter(~E.col("has_ws") & ~E.col("has_cs"))


def q10(max_groups: int = 1 << 12) -> P.PlanNode:
    """Demographic counts of county customers active in store + web/catalog."""
    c = _active_customers("either")
    ca = _scan("customer_address").filter(
        E.col("ca_county").isin("county 0", "county 1", "county 2", "county 3", "county 4")
    )
    j = _j(c, ca, ["c_current_addr_sk"], ["ca_address_sk"])
    j = _j(j, _scan("customer_demographics"), ["c_current_cdemo_sk"], ["cd_demo_sk"])
    agg = j.aggregate(
        [E.col("cd_gender"), E.col("cd_marital_status"), E.col("cd_education_status"),
         E.col("cd_purchase_estimate"), E.col("cd_credit_rating")],
        [E.AggExpr("count", None, "cnt")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("cd_gender")), E.SortOrder(E.col("cd_marital_status")),
         E.SortOrder(E.col("cd_education_status")), E.SortOrder(E.col("cd_purchase_estimate")),
         E.SortOrder(E.col("cd_credit_rating"))],
        fetch=100,
    )


def q35(max_groups: int = 1 << 12) -> P.PlanNode:
    """State/demographic profile of active customers with dependent stats."""
    c = _active_customers("either")
    j = _j(c, _scan("customer_address"), ["c_current_addr_sk"], ["ca_address_sk"])
    j = _j(j, _scan("customer_demographics"), ["c_current_cdemo_sk"], ["cd_demo_sk"])
    agg = j.aggregate(
        [E.col("ca_state"), E.col("cd_gender"), E.col("cd_marital_status"),
         E.col("cd_dep_count"), E.col("cd_dep_employed_count"), E.col("cd_dep_college_count")],
        [
            E.AggExpr("count", None, "cnt1"),
            E.AggExpr("max", E.col("cd_dep_count"), "max_dep"),
            E.AggExpr("sum", E.col("cd_dep_employed_count"), "sum_emp"),
            E.AggExpr("avg", E.col("cd_dep_college_count").cast(T.FLOAT64), "avg_col"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("ca_state")), E.SortOrder(E.col("cd_gender")),
         E.SortOrder(E.col("cd_marital_status")), E.SortOrder(E.col("cd_dep_count")),
         E.SortOrder(E.col("cd_dep_employed_count")),
         E.SortOrder(E.col("cd_dep_college_count"))],
        fetch=100,
    )


def q69(max_groups: int = 1 << 12) -> P.PlanNode:
    """Demographics of store-only customers (anti web/catalog)."""
    c = _active_customers("neither")
    ca = _scan("customer_address").filter(E.col("ca_state").isin("CA", "TX", "NY"))
    j = _j(c, ca, ["c_current_addr_sk"], ["ca_address_sk"])
    j = _j(j, _scan("customer_demographics"), ["c_current_cdemo_sk"], ["cd_demo_sk"])
    agg = j.aggregate(
        [E.col("cd_gender"), E.col("cd_marital_status"), E.col("cd_education_status"),
         E.col("cd_purchase_estimate"), E.col("cd_credit_rating")],
        [E.AggExpr("count", None, "cnt")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("cd_gender")), E.SortOrder(E.col("cd_marital_status")),
         E.SortOrder(E.col("cd_education_status")), E.SortOrder(E.col("cd_purchase_estimate")),
         E.SortOrder(E.col("cd_credit_rating"))],
        fetch=100,
    )


def q13() -> P.PlanNode:
    """Single-row store-sales averages under OR'd demographic/address bands."""
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2001))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, _scan("customer_demographics"), ["ss_cdemo_sk"], ["cd_demo_sk"])
    j = _j(j, _scan("household_demographics"), ["ss_hdemo_sk"], ["hd_demo_sk"])
    j = _j(j, _scan("customer_address"), ["ss_addr_sk"], ["ca_address_sk"])
    demo = (
        ((E.col("cd_marital_status") == E.lit("M"))
         & E.col("ss_sales_price").between(E.lit(0, T.decimal(7, 2)), E.lit(150, T.decimal(7, 2)))
         & E.col("hd_dep_count").between(0, 4))
        | ((E.col("cd_marital_status") == E.lit("S"))
           & E.col("ss_sales_price").between(E.lit(50, T.decimal(7, 2)), E.lit(200, T.decimal(7, 2)))
           & E.col("hd_dep_count").between(1, 6))
        | ((E.col("cd_marital_status") == E.lit("W"))
           & E.col("ss_sales_price").between(E.lit(25, T.decimal(7, 2)), E.lit(175, T.decimal(7, 2)))
           & E.col("hd_dep_count").between(3, 9))
    )
    addr = (
        (E.col("ca_state").isin("CA", "TX") & E.col("ss_net_profit").between(
            E.lit(-500, T.decimal(7, 2)), E.lit(1000, T.decimal(7, 2))))
        | (E.col("ca_state").isin("NY", "FL") & E.col("ss_net_profit").between(
            E.lit(0, T.decimal(7, 2)), E.lit(2000, T.decimal(7, 2))))
        | (E.col("ca_state").isin("WA", "GA") & E.col("ss_net_profit").between(
            E.lit(50, T.decimal(7, 2)), E.lit(1500, T.decimal(7, 2))))
    )
    j = j.filter(demo & addr)
    return j.aggregate(
        [],
        [
            E.AggExpr("avg", E.col("ss_quantity"), "avg_qty"),
            E.AggExpr("avg", E.col("ss_ext_sales_price").cast(T.FLOAT64), "avg_esp"),
            E.AggExpr("avg", E.col("ss_ext_wholesale_cost").cast(T.FLOAT64), "avg_ewc"),
            E.AggExpr("sum", E.col("ss_ext_wholesale_cost"), "sum_ewc"),
        ],
    )


def q48() -> P.PlanNode:
    """Single-row quantity sum under OR'd demographic/address bands."""
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2000))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, _scan("customer_demographics"), ["ss_cdemo_sk"], ["cd_demo_sk"])
    j = _j(j, _scan("customer_address"), ["ss_addr_sk"], ["ca_address_sk"])
    demo = (
        ((E.col("cd_marital_status") == E.lit("M")) & (E.col("cd_education_status") == E.lit("4 yr Degree"))
         & E.col("ss_sales_price").between(E.lit(100, T.decimal(7, 2)), E.lit(150, T.decimal(7, 2))))
        | ((E.col("cd_marital_status") == E.lit("D")) & (E.col("cd_education_status") == E.lit("Secondary"))
           & E.col("ss_sales_price").between(E.lit(50, T.decimal(7, 2)), E.lit(100, T.decimal(7, 2))))
        | ((E.col("cd_marital_status") == E.lit("S")) & (E.col("cd_education_status") == E.lit("College"))
           & E.col("ss_sales_price").between(E.lit(150, T.decimal(7, 2)), E.lit(200, T.decimal(7, 2))))
    )
    addr = (
        (E.col("ca_state").isin("CA", "TX") & E.col("ss_net_profit").between(
            E.lit(0, T.decimal(7, 2)), E.lit(2000, T.decimal(7, 2))))
        | (E.col("ca_state").isin("NY", "FL") & E.col("ss_net_profit").between(
            E.lit(150, T.decimal(7, 2)), E.lit(300, T.decimal(7, 2))))
        | (E.col("ca_state").isin("WA", "GA") & E.col("ss_net_profit").between(
            E.lit(50, T.decimal(7, 2)), E.lit(250, T.decimal(7, 2))))
    )
    j = j.filter(demo & addr)
    return j.aggregate([], [E.AggExpr("sum", E.col("ss_quantity"), "total_qty")])


def _excess_discount(fact: str, date_col: str, item_col: str, disc_col: str,
                     manufact: int) -> P.PlanNode:
    """q32/q92 shape: discounts above 1.3× the per-item window average."""
    dt = _scan("date_dim").filter(E.col("d_date_sk").between(100, 190))
    it = _scan("item").filter(E.col("i_manufact_id") == E.lit(manufact))
    base = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
    base = _j(base, it, [item_col], ["i_item_sk"])
    keep = _exceeds_group_avg(base, item_col, disc_col, 1.3, 1 << 12)
    return keep.aggregate([], [E.AggExpr("sum", E.col(disc_col), "excess_discount")])


def q32() -> P.PlanNode:
    """Catalog excess discount amount."""
    return _excess_discount("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                            "cs_ext_discount_amt", 77)


def q92() -> P.PlanNode:
    """Web excess discount amount."""
    return _excess_discount("web_sales", "ws_sold_date_sk", "ws_item_sk",
                            "ws_ext_discount_amt", 35)


def _returns_above_state_avg(rfact: str, cust_col: str, date_col: str, amt_col: str,
                             home_states, max_groups: int) -> P.PlanNode:
    """q30/q81 shape: per-customer channel returns above 1.2× the state
    average, joined back to home-state customers."""
    dt = _scan("date_dim").filter(E.col("d_year").isin(1999, 2000, 2001))
    r = _j(_scan(rfact), dt, [date_col], ["d_date_sk"])
    ctr = _j(r, _scan("customer"), [cust_col], ["c_customer_sk"])
    ctr = _j(ctr, _scan("customer_address"), ["c_current_addr_sk"], ["ca_address_sk"])
    ctr = ctr.aggregate(
        [E.col(cust_col), E.col("ca_state")],
        [E.AggExpr("sum", E.col(amt_col), "ctr_total_return")],
    )
    ctr.max_groups = max_groups
    keep = _exceeds_group_avg(ctr, "ca_state", "ctr_total_return", 1.2, 64)
    c = _scan("customer")
    j = P.HashJoin(keep, c, (E.col(cust_col),), (E.col("c_customer_sk"),),
                   P.JoinType.INNER, "right")
    home = _scan("customer_address").filter(E.col("ca_state").isin(*home_states)).project(
        [E.col("ca_address_sk").alias("home_addr_sk")]
    )
    j = _j(j, home, ["c_current_addr_sk"], ["home_addr_sk"])
    return j.project(
        [E.col("c_customer_id"), E.col("c_salutation"), E.col("c_first_name"),
         E.col("c_last_name"), E.col("ctr_total_return")]
    ).sort(
        [E.SortOrder(E.col("c_customer_id")), E.SortOrder(E.col("ctr_total_return"))],
        fetch=100,
    )


def q30(max_groups: int = 1 << 16) -> P.PlanNode:
    """Web returners above 1.2× their state's average, home state CA."""
    return _returns_above_state_avg("web_returns", "wr_returning_customer_sk",
                                    "wr_returned_date_sk", "wr_return_amt", ("CA", "TX", "NY", "FL"), max_groups)


def q81(max_groups: int = 1 << 16) -> P.PlanNode:
    """Catalog returners above 1.2× their state's average, home state TX."""
    return _returns_above_state_avg("catalog_returns", "cr_returning_customer_sk",
                                    "cr_returned_date_sk", "cr_return_amount", ("TX", "WA", "GA", "IL"), max_groups)


def _multi_warehouse_orders(fact: str, order_col: str, wh_col: str,
                            rfact: str, rorder_col: str,
                            date_col: str, ship_date_lo: int, ship_date_hi: int,
                            addr_col: str, state: str,
                            site_scan: str, site_join: str, site_key: str,
                            ship_cost_col: str, profit_col: str) -> P.PlanNode:
    """q16/q94 shape: orders shipped from ≥2 warehouses (self-exists),
    never returned (anti), within a ship-date window and state."""
    multi = _scan(fact).aggregate(
        [E.col(order_col)],
        [E.AggExpr("count_distinct", E.col(wh_col), "n_wh")],
    )
    multi.max_groups = 1 << 16
    multi = multi.filter(E.col("n_wh") >= E.lit(2)).project(
        [E.col(order_col).alias("multi_order")]
    )
    dt = _scan("date_dim").filter(E.col("d_date_sk").between(ship_date_lo, ship_date_hi))
    ca = _scan("customer_address").filter(E.col("ca_state") == E.lit(state))
    j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
    j = _j(j, ca, [addr_col], ["ca_address_sk"])
    j = _j(j, _scan(site_scan), [site_join], [site_key])
    j = P.HashJoin(j, multi, (E.col(order_col),), (E.col("multi_order"),),
                   P.JoinType.LEFT_SEMI, "right")
    returned = _scan(rfact).aggregate(
        [E.col(rorder_col)], [E.AggExpr("count", None, "n_r")]
    )
    returned.max_groups = 1 << 16
    j = P.HashJoin(j, returned.project([E.col(rorder_col)]),
                   (E.col(order_col),), (E.col(rorder_col),),
                   P.JoinType.LEFT_ANTI, "right")
    # count(distinct order) alongside plain sums: pre-aggregate per order,
    # then count rows + sum the partial sums (same decomposition DataFusion
    # planner uses for single-distinct + other aggs)
    per_order = j.aggregate(
        [E.col(order_col)],
        [E.AggExpr("sum", E.col(ship_cost_col), "ship_part"),
         E.AggExpr("sum", E.col(profit_col), "profit_part")],
    )
    per_order.max_groups = 1 << 16
    return per_order.aggregate(
        [],
        [
            E.AggExpr("count", None, "order_count"),
            E.AggExpr("sum", E.col("ship_part"), "total_shipping_cost"),
            E.AggExpr("sum", E.col("profit_part"), "total_net_profit"),
        ],
    )


def q16() -> P.PlanNode:
    """Catalog multi-warehouse never-returned order stats."""
    return _multi_warehouse_orders(
        "catalog_sales", "cs_order_number", "cs_warehouse_sk",
        "catalog_returns", "cr_order_number",
        "cs_ship_date_sk", 60, 120, "cs_ship_addr_sk", "GA",
        "call_center", "cs_call_center_sk", "cc_call_center_sk",
        "cs_ext_ship_cost", "cs_net_profit")


def q94() -> P.PlanNode:
    """Web multi-warehouse never-returned order stats."""
    return _multi_warehouse_orders(
        "web_sales", "ws_order_number", "ws_warehouse_sk",
        "web_returns", "wr_order_number",
        "ws_ship_date_sk", 60, 120, "ws_ship_addr_sk", "IL",
        "web_site", "ws_web_site_sk", "web_site_sk",
        "ws_ext_ship_cost", "ws_net_profit")


def q85(max_groups: int = 1 << 10) -> P.PlanNode:
    """Web return reasons with demographic/address band filters."""
    wr = _scan("web_returns").aggregate(
        [E.col("wr_item_sk"), E.col("wr_order_number"), E.col("wr_reason_sk"),
         E.col("wr_refunded_cash"), E.col("wr_web_page_sk")],
        [E.AggExpr("sum", E.col("wr_return_quantity"), "ret_qty")],
    )
    wr.max_groups = 1 << 16
    j = P.HashJoin(_scan("web_sales"), wr,
                   (E.col("ws_item_sk"), E.col("ws_order_number")),
                   (E.col("wr_item_sk"), E.col("wr_order_number")),
                   P.JoinType.INNER, "right")
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2000))
    j = _j(j, dt, ["ws_sold_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("web_page"), ["ws_web_page_sk"], ["wp_web_page_sk"])
    j = _j(j, _scan("reason"), ["wr_reason_sk"], ["r_reason_sk"])
    j = _j(j, _scan("customer_demographics"), ["ws_bill_customer_sk"], ["cd_demo_sk"])
    band = (
        ((E.col("cd_marital_status") == E.lit("M"))
         & E.col("ws_sales_price").between(E.lit(0, T.decimal(7, 2)), E.lit(150, T.decimal(7, 2))))
        | ((E.col("cd_marital_status") == E.lit("S"))
           & E.col("ws_sales_price").between(E.lit(50, T.decimal(7, 2)), E.lit(200, T.decimal(7, 2))))
        | ((E.col("cd_marital_status") == E.lit("W"))
           & E.col("ws_sales_price").between(E.lit(25, T.decimal(7, 2)), E.lit(175, T.decimal(7, 2))))
    )
    j = j.filter(band)
    agg = j.aggregate(
        [E.col("r_reason_desc")],
        [
            E.AggExpr("avg", E.col("ws_quantity"), "avg_qty"),
            E.AggExpr("avg", E.col("wr_refunded_cash").cast(T.FLOAT64), "avg_refund"),
            E.AggExpr("avg", E.col("ret_qty"), "avg_ret_qty"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("r_reason_desc")), E.SortOrder(E.col("avg_qty"))], fetch=100
    )


def q93(max_groups: int = 1 << 16) -> P.PlanNode:
    """Actual net paid per customer after reason-specific returns."""
    sr = _j(_scan("store_returns"),
            _scan("reason").filter(E.col("r_reason_desc") == E.lit("reason 3")),
            ["sr_reason_sk"], ["r_reason_sk"])
    sra = sr.aggregate(
        [E.col("sr_item_sk"), E.col("sr_ticket_number")],
        [E.AggExpr("sum", E.col("sr_return_quantity"), "ret_qty")],
    )
    sra.max_groups = 1 << 16
    j = P.HashJoin(_scan("store_sales"), sra,
                   (E.col("ss_item_sk"), E.col("ss_ticket_number")),
                   (E.col("sr_item_sk"), E.col("sr_ticket_number")),
                   P.JoinType.INNER, "right")
    act = j.project([
        E.col("ss_customer_sk"),
        (E.if_(
            E.col("ret_qty").is_not_null(),
            (E.col("ss_quantity") - E.col("ret_qty")).cast(T.decimal(10, 0)),
            E.col("ss_quantity").cast(T.decimal(10, 0)),
        ) * E.col("ss_sales_price")).alias("act_sales"),
    ])
    agg = act.aggregate([E.col("ss_customer_sk")],
                        [E.AggExpr("sum", E.col("act_sales"), "sumsales")])
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("sumsales")), E.SortOrder(E.col("ss_customer_sk"))],
        fetch=100,
    )


# ---------------------------------------------------------------------------
# Year-over-year self-join family: a shared aggregate reused under several
# filters and joined against itself (the CTE reuse pattern; reference:
# Spark reuses the exchange, here the sub-aggregate appears once per arm)
# ---------------------------------------------------------------------------


def _dow_pivot_aggs(price_col: str):
    return [
        E.AggExpr("sum", E.if_(E.col("d_dow") == E.lit(d), E.col(price_col),
                               E.lit(None, T.NULLTYPE)), name)
        for d, name in [(0, "mon"), (1, "tue"), (2, "wed"), (3, "thu"),
                        (4, "fri"), (5, "sat"), (6, "sun")]
    ]


_DOW_NAMES = ["mon", "tue", "wed", "thu", "fri", "sat", "sun"]


def q2() -> P.PlanNode:
    """Web+catalog weekly day-of-week sales, year-over-year ratio (53-week
    offset self-join of the shared weekly pivot)."""
    u = P.Union((
        _scan("web_sales").project([E.col("ws_sold_date_sk").alias("sold_date_sk"),
                                    E.col("ws_ext_sales_price").alias("sales_price")]),
        _scan("catalog_sales").project([E.col("cs_sold_date_sk").alias("sold_date_sk"),
                                        E.col("cs_ext_sales_price").alias("sales_price")]),
    ))
    j = _j(u, _scan("date_dim"), ["sold_date_sk"], ["d_date_sk"])
    wswscs = j.aggregate([E.col("d_week_seq")], _dow_pivot_aggs("sales_price"))
    wswscs.max_groups = 1 << 10

    def year_weeks(year, prefix):
        wk = _scan("date_dim").filter(E.col("d_year") == E.lit(year)).aggregate(
            [E.col("d_week_seq")], [E.AggExpr("count", None, "n")]
        )
        wk.max_groups = 1 << 10
        sel = P.HashJoin(wswscs, wk.project([E.col("d_week_seq").alias("wk")]),
                         (E.col("d_week_seq"),), (E.col("wk"),),
                         P.JoinType.LEFT_SEMI, "right")
        return sel.project(
            [E.col("d_week_seq").alias(f"{prefix}_week_seq")]
            + [E.col(n).alias(f"{prefix}_{n}") for n in _DOW_NAMES]
        )

    y1 = year_weeks(1999, "y1")
    y2 = year_weeks(2000, "y2")
    y2 = y2.project([(E.col("y2_week_seq") - E.lit(53)).alias("y2_week_off")]
                    + [E.col(f"y2_{n}") for n in _DOW_NAMES])
    j2 = P.HashJoin(y1, y2, (E.col("y1_week_seq"),), (E.col("y2_week_off"),),
                    P.JoinType.INNER, "right")
    ratios = [
        (E.col(f"y1_{n}").cast(T.FLOAT64) / E.col(f"y2_{n}").cast(T.FLOAT64)).alias(f"r_{n}")
        for n in _DOW_NAMES
    ]
    return j2.project([E.col("y1_week_seq")] + ratios).sort(
        [E.SortOrder(E.col("y1_week_seq"))], fetch=100
    )


def q59(max_groups: int = 1 << 12) -> P.PlanNode:
    """Store weekly day-of-week sales, year-over-year by store (52-week
    offset self-join; joins store twice)."""
    j = _j(_scan("store_sales"), _scan("date_dim"), ["ss_sold_date_sk"], ["d_date_sk"])
    wss = j.aggregate([E.col("d_week_seq"), E.col("ss_store_sk")],
                      _dow_pivot_aggs("ss_sales_price"))
    wss.max_groups = max_groups

    def arm(year, prefix):
        wk = _scan("date_dim").filter(E.col("d_year") == E.lit(year)).aggregate(
            [E.col("d_week_seq")], [E.AggExpr("count", None, "n")]
        )
        wk.max_groups = 1 << 10
        sel = P.HashJoin(wss, wk.project([E.col("d_week_seq").alias("wk")]),
                         (E.col("d_week_seq"),), (E.col("wk"),),
                         P.JoinType.LEFT_SEMI, "right")
        sel = _j(sel, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
        return sel.project(
            [E.col("s_store_name").alias(f"{prefix}_store_name"),
             E.col("s_store_id").alias(f"{prefix}_store_id"),
             E.col("d_week_seq").alias(f"{prefix}_week_seq")]
            + [E.col(n).alias(f"{prefix}_{n}") for n in _DOW_NAMES]
        )

    y = arm(1999, "y")
    x = arm(2000, "x")
    x = x.project([E.col("x_store_id"),
                   (E.col("x_week_seq") - E.lit(52)).alias("x_week_off")]
                  + [E.col(f"x_{n}") for n in _DOW_NAMES])
    j2 = P.HashJoin(y, x, (E.col("y_store_id"), E.col("y_week_seq")),
                    (E.col("x_store_id"), E.col("x_week_off")), P.JoinType.INNER, "right")
    ratios = [
        (E.col(f"y_{n}").cast(T.FLOAT64) / E.col(f"x_{n}").cast(T.FLOAT64)).alias(f"r_{n}")
        for n in _DOW_NAMES
    ]
    return j2.project(
        [E.col("y_store_name"), E.col("y_store_id"), E.col("y_week_seq")] + ratios
    ).sort(
        [E.SortOrder(E.col("y_store_name")), E.SortOrder(E.col("y_store_id")),
         E.SortOrder(E.col("y_week_seq"))],
        fetch=100,
    )


def _year_total(fact: str, cust_col: str, date_col: str, formula, year: int,
                prefix: str, max_groups: int) -> P.PlanNode:
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(year))
    j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
    agg = j.aggregate([E.col(cust_col)], [E.AggExpr("sum", formula, "total")])
    agg.max_groups = max_groups
    return agg.project([E.col(cust_col).alias(f"{prefix}_cust"),
                        E.col("total").alias(f"{prefix}_total")])


def _growth_compare(store_formula, web_formula, extra_catalog=None,
                    max_groups: int = 1 << 16) -> P.PlanNode:
    """q4/q11/q74 skeleton: per-customer totals per channel per year; keep
    customers whose web (and catalog) growth exceeds store growth."""
    s1 = _year_total("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                     store_formula, 1999, "s1", max_groups)
    s2 = _year_total("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                     store_formula, 2000, "s2", max_groups)
    w1 = _year_total("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
                     web_formula, 1999, "w1", max_groups)
    w2 = _year_total("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
                     web_formula, 2000, "w2", max_groups)
    j = P.HashJoin(s1, s2, (E.col("s1_cust"),), (E.col("s2_cust"),), P.JoinType.INNER, "right")
    j = P.HashJoin(j, w1, (E.col("s1_cust"),), (E.col("w1_cust"),), P.JoinType.INNER, "right")
    j = P.HashJoin(j, w2, (E.col("s1_cust"),), (E.col("w2_cust"),), P.JoinType.INNER, "right")
    cond = (
        (E.col("s1_total").cast(T.FLOAT64) > E.lit(0.0))
        & (E.col("w1_total").cast(T.FLOAT64) > E.lit(0.0))
        & (E.col("w2_total").cast(T.FLOAT64) / E.col("w1_total").cast(T.FLOAT64)
           > E.col("s2_total").cast(T.FLOAT64) / E.col("s1_total").cast(T.FLOAT64))
    )
    if extra_catalog is not None:
        c1 = _year_total("catalog_sales", "cs_bill_customer_sk", "cs_sold_date_sk",
                         extra_catalog, 1999, "c1", max_groups)
        c2 = _year_total("catalog_sales", "cs_bill_customer_sk", "cs_sold_date_sk",
                         extra_catalog, 2000, "c2", max_groups)
        j = P.HashJoin(j, c1, (E.col("s1_cust"),), (E.col("c1_cust"),), P.JoinType.INNER, "right")
        j = P.HashJoin(j, c2, (E.col("s1_cust"),), (E.col("c2_cust"),), P.JoinType.INNER, "right")
        cond = cond & (
            (E.col("c1_total").cast(T.FLOAT64) > E.lit(0.0))
            & (E.col("c2_total").cast(T.FLOAT64) / E.col("c1_total").cast(T.FLOAT64)
               > E.col("s2_total").cast(T.FLOAT64) / E.col("s1_total").cast(T.FLOAT64))
        )
    keep = j.filter(cond)
    keep = P.HashJoin(keep, _scan("customer"), (E.col("s1_cust"),),
                      (E.col("c_customer_sk"),), P.JoinType.INNER, "right")
    return keep.project(
        [E.col("c_customer_id"), E.col("c_first_name"), E.col("c_last_name")]
    ).sort([E.SortOrder(E.col("c_customer_id"))], fetch=100)


def q74(max_groups: int = 1 << 16) -> P.PlanNode:
    """Customers whose web net-paid growth beat store growth."""
    return _growth_compare(E.col("ss_net_paid"), E.col("ws_net_paid"),
                           None, max_groups)


def q11(max_groups: int = 1 << 16) -> P.PlanNode:
    """Customers whose web (list − discount) growth beat store growth."""
    return _growth_compare(
        E.col("ss_ext_list_price") - E.col("ss_ext_discount_amt"),
        E.col("ws_ext_list_price") - E.col("ws_ext_discount_amt"),
        None, max_groups)


def q4(max_groups: int = 1 << 16) -> P.PlanNode:
    """Customers whose web AND catalog growth beat store growth
    (((list − wholesale − discount) + sales) / 2 formula)."""
    half = E.lit(2, T.decimal(10, 0))

    def formula(lp, wc, dc, sp):
        return (E.col(lp) - E.col(wc) - E.col(dc) + E.col(sp)) / half

    return _growth_compare(
        formula("ss_ext_list_price", "ss_ext_wholesale_cost",
                "ss_ext_discount_amt", "ss_ext_sales_price"),
        formula("ws_ext_list_price", "ws_ext_ship_cost",
                "ws_ext_discount_amt", "ws_ext_sales_price"),
        formula("cs_ext_list_price", "cs_ext_ship_cost",
                "cs_ext_discount_amt", "cs_ext_sales_price"),
        max_groups)


def q31(max_groups: int = 1 << 12) -> P.PlanNode:
    """Counties where web sales grew faster than store sales across three
    consecutive quarters of 2000."""
    def arm(fact, date_col, addr_col, price_col, qoy, prefix):
        dt = _scan("date_dim").filter(
            (E.col("d_year") == E.lit(2000)) & (E.col("d_qoy") == E.lit(qoy))
        )
        j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        j = _j(j, _scan("customer_address"), [addr_col], ["ca_address_sk"])
        agg = j.aggregate([E.col("ca_county")],
                          [E.AggExpr("sum", E.col(price_col), "total")])
        agg.max_groups = max_groups
        return agg.project([E.col("ca_county").alias(f"{prefix}_county"),
                            E.col("total").alias(f"{prefix}_sales")])

    ss1 = arm("store_sales", "ss_sold_date_sk", "ss_addr_sk", "ss_ext_sales_price", 1, "ss1")
    ss2 = arm("store_sales", "ss_sold_date_sk", "ss_addr_sk", "ss_ext_sales_price", 2, "ss2")
    ss3 = arm("store_sales", "ss_sold_date_sk", "ss_addr_sk", "ss_ext_sales_price", 3, "ss3")
    ws1 = arm("web_sales", "ws_sold_date_sk", "ws_ship_addr_sk", "ws_ext_sales_price", 1, "ws1")
    ws2 = arm("web_sales", "ws_sold_date_sk", "ws_ship_addr_sk", "ws_ext_sales_price", 2, "ws2")
    ws3 = arm("web_sales", "ws_sold_date_sk", "ws_ship_addr_sk", "ws_ext_sales_price", 3, "ws3")
    j = ss1
    for nxt, key in [(ss2, "ss2_county"), (ss3, "ss3_county"), (ws1, "ws1_county"),
                     (ws2, "ws2_county"), (ws3, "ws3_county")]:
        j = P.HashJoin(j, nxt, (E.col("ss1_county"),), (E.col(key),), P.JoinType.INNER, "right")
    f64 = lambda c: E.col(c).cast(T.FLOAT64)  # noqa: E731
    keep = j.filter(
        (f64("ss1_sales") > E.lit(0.0)) & (f64("ss2_sales") > E.lit(0.0))
        & (f64("ws1_sales") > E.lit(0.0)) & (f64("ws2_sales") > E.lit(0.0))
        & (f64("ws2_sales") / f64("ws1_sales") > f64("ss2_sales") / f64("ss1_sales"))
        & (f64("ws3_sales") / f64("ws2_sales") > f64("ss3_sales") / f64("ss2_sales"))
    )
    return keep.project(
        [E.col("ss1_county"),
         (f64("ws2_sales") / f64("ws1_sales")).alias("web_q1_q2_increase"),
         (f64("ss2_sales") / f64("ss1_sales")).alias("store_q1_q2_increase"),
         (f64("ws3_sales") / f64("ws2_sales")).alias("web_q2_q3_increase"),
         (f64("ss3_sales") / f64("ss2_sales")).alias("store_q2_q3_increase")]
    ).sort([E.SortOrder(E.col("ss1_county"))], fetch=100)


# ---------------------------------------------------------------------------
# Inventory / misc family: before-after pivots, scalar-bucket cross joins,
# intersect/except as semi/anti joins, moment-based joined statistics, and
# the q64 cross-channel two-year self-join
# ---------------------------------------------------------------------------


def _cross(left: P.PlanNode, right: P.PlanNode) -> P.PlanNode:
    """Cross join a single-row aggregate onto the left side (scalar
    subquery materialization; reference: BNLJ with no condition)."""
    return P.BroadcastNestedLoopJoin(left, right, P.JoinType.INNER, None)


def q21(max_groups: int = 1 << 14) -> P.PlanNode:
    """Inventory before/after a pivot date per warehouse/item, keeping
    ratios within [2/3, 3/2]."""
    dt = _scan("date_dim").filter(E.col("d_date_sk").between(300, 400))
    it = _scan("item").filter(
        E.col("i_current_price").between(E.lit(1, T.decimal(7, 2)), E.lit(300, T.decimal(7, 2))))
    j = _j(_scan("inventory"), dt, ["inv_date_sk"], ["d_date_sk"])
    j = _j(j, it, ["inv_item_sk"], ["i_item_sk"])
    j = _j(j, _scan("warehouse"), ["inv_warehouse_sk"], ["w_warehouse_sk"])
    pivot = E.lit(350)
    agg = j.aggregate(
        [E.col("w_warehouse_name"), E.col("i_item_id")],
        [
            E.AggExpr("sum", E.if_(E.col("inv_date_sk") < pivot,
                                   E.col("inv_quantity_on_hand"), E.lit(0)),
                      "inv_before"),
            E.AggExpr("sum", E.if_(E.col("inv_date_sk") >= pivot,
                                   E.col("inv_quantity_on_hand"), E.lit(0)),
                      "inv_after"),
        ],
    )
    agg.max_groups = max_groups
    keep = agg.filter(
        E.if_(E.col("inv_before") > E.lit(0),
              E.col("inv_after").cast(T.FLOAT64) / E.col("inv_before").cast(T.FLOAT64),
              E.lit(None, T.FLOAT64)).between(E.lit(2.0 / 3.0), E.lit(3.0 / 2.0))
    )
    return keep.sort(
        [E.SortOrder(E.col("w_warehouse_name")), E.SortOrder(E.col("i_item_id"))],
        fetch=100,
    )


def _item_inventory_shortlist(fact: str, item_col: str, date_col: str,
                              manufacts, max_groups: int) -> P.PlanNode:
    """q37/q82 shape: in-stock items (inventory 100..500 in a window)
    currently sold through the channel."""
    it = _scan("item").filter(
        E.col("i_current_price").between(E.lit(10, T.decimal(7, 2)), E.lit(250, T.decimal(7, 2)))
        & E.col("i_manufact_id").isin(*manufacts)
    )
    dt = _scan("date_dim").filter(E.col("d_date_sk").between(300, 360))
    inv = _j(_scan("inventory"), dt, ["inv_date_sk"], ["d_date_sk"]).filter(
        E.col("inv_quantity_on_hand").between(100, 500)
    ).aggregate([E.col("inv_item_sk")], [E.AggExpr("count", None, "n_inv")])
    inv.max_groups = 1 << 12
    it = P.HashJoin(it, inv.project([E.col("inv_item_sk")]),
                    (E.col("i_item_sk"),), (E.col("inv_item_sk"),),
                    P.JoinType.LEFT_SEMI, "right")
    sold = _scan(fact).aggregate([E.col(item_col)], [E.AggExpr("count", None, "n_sold")])
    sold.max_groups = 1 << 14
    it = P.HashJoin(it, sold.project([E.col(item_col)]),
                    (E.col("i_item_sk"),), (E.col(item_col),),
                    P.JoinType.LEFT_SEMI, "right")
    agg = it.aggregate(
        [E.col("i_item_id"), E.col("i_item_desc"), E.col("i_current_price")],
        [E.AggExpr("count", None, "n")],
    )
    agg.max_groups = max_groups
    return agg.sort([E.SortOrder(E.col("i_item_id"))], fetch=100)


def q37(max_groups: int = 1 << 12) -> P.PlanNode:
    """Catalog items in stock (manufacturer shortlist)."""
    return _item_inventory_shortlist("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
                                     range(1, 500), max_groups)


def q82(max_groups: int = 1 << 12) -> P.PlanNode:
    """Store items in stock (manufacturer shortlist)."""
    return _item_inventory_shortlist("store_sales", "ss_item_sk", "ss_sold_date_sk",
                                     range(300, 800), max_groups)


def q72(max_groups: int = 1 << 16) -> P.PlanNode:
    """Catalog orders short on same-week inventory, by item/warehouse/week."""
    d1 = _scan("date_dim").project([E.col("d_date_sk").alias("d1_sk"),
                                    E.col("d_week_seq").alias("wk1")])
    d2 = _scan("date_dim").project([E.col("d_date_sk").alias("d2_sk"),
                                    E.col("d_week_seq").alias("wk2")])
    hd = _scan("household_demographics").filter(
        E.col("hd_buy_potential") == E.lit(">10000"))
    cd = _scan("customer_demographics").filter(E.col("cd_marital_status") == E.lit("M"))
    j = _j(_scan("catalog_sales"), d1, ["cs_sold_date_sk"], ["d1_sk"])
    j = _j(j, cd, ["cs_cdemo_sk"], ["cd_demo_sk"])
    # join inventory on (item, week) — not item alone — so the static join
    # capacity tracks the real match rate instead of the per-item fan-out
    inv = _j(_scan("inventory"), d2, ["inv_date_sk"], ["d2_sk"])
    j = P.HashJoin(j, inv, (E.col("cs_item_sk"), E.col("wk1")),
                   (E.col("inv_item_sk"), E.col("wk2")), P.JoinType.INNER, "right")
    j = j.filter(E.col("inv_quantity_on_hand") < E.col("cs_quantity"))
    j = _j(j, _scan("warehouse"), ["inv_warehouse_sk"], ["w_warehouse_sk"])
    j = _j(j, _scan("item"), ["cs_item_sk"], ["i_item_sk"])
    agg = j.aggregate(
        [E.col("i_item_desc"), E.col("w_warehouse_name"), E.col("wk1")],
        [E.AggExpr("count", None, "no_promo")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("no_promo"), ascending=False),
         E.SortOrder(E.col("i_item_desc")), E.SortOrder(E.col("w_warehouse_name")),
         E.SortOrder(E.col("wk1"))],
        fetch=100,
    )


def q29(max_groups: int = 1 << 16) -> P.PlanNode:
    """Quantity flow store→return→catalog-rebuy (q25 shape, quantity sums)."""
    d1 = _scan("date_dim").filter(E.col("d_year").isin(1999, 2000, 2001)).project(
        [E.col("d_date_sk").alias("d1_sk")])
    d2 = _scan("date_dim").filter(E.col("d_year").isin(1999, 2000, 2001)).project(
        [E.col("d_date_sk").alias("d2_sk")])
    d3 = _scan("date_dim").filter(E.col("d_year").isin(2000, 2001, 2002)).project(
        [E.col("d_date_sk").alias("d3_sk")])
    cs = _j(_scan("catalog_sales"), d3, ["cs_sold_date_sk"], ["d3_sk"])
    cs_agg = cs.aggregate(
        [E.col("cs_bill_customer_sk"), E.col("cs_item_sk")],
        [E.AggExpr("sum", E.col("cs_quantity"), "cs_qty_sum"),
         E.AggExpr("count", None, "cs_cnt")],
    )
    cs_agg.max_groups = max_groups
    j = P.HashJoin(
        _scan("store_sales"), _scan("store_returns"),
        (E.col("ss_customer_sk"), E.col("ss_item_sk"), E.col("ss_ticket_number")),
        (E.col("sr_customer_sk"), E.col("sr_item_sk"), E.col("sr_ticket_number")),
        P.JoinType.INNER, "right",
    )
    j = _j(j, d1, ["ss_sold_date_sk"], ["d1_sk"])
    j = _j(j, d2, ["sr_returned_date_sk"], ["d2_sk"])
    j = P.HashJoin(j, cs_agg,
                   (E.col("ss_customer_sk"), E.col("ss_item_sk")),
                   (E.col("cs_bill_customer_sk"), E.col("cs_item_sk")),
                   P.JoinType.INNER, "right")
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, _scan("item"), ["ss_item_sk"], ["i_item_sk"])
    agg = j.aggregate(
        [E.col("i_item_id"), E.col("i_item_desc"), E.col("s_store_id"), E.col("s_store_name")],
        [
            E.AggExpr("sum", E.col("ss_quantity") * E.col("cs_cnt"), "store_sales_quantity"),
            E.AggExpr("sum", E.col("sr_return_quantity") * E.col("cs_cnt"),
                      "store_returns_quantity"),
            E.AggExpr("sum", E.col("cs_qty_sum"), "catalog_sales_quantity"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("i_item_id")), E.SortOrder(E.col("i_item_desc")),
         E.SortOrder(E.col("s_store_id")), E.SortOrder(E.col("s_store_name"))],
        fetch=100,
    )


def q40(max_groups: int = 1 << 14) -> P.PlanNode:
    """Catalog sales net of returns before/after a pivot date by state/item."""
    cr = _returns_agg("catalog_returns", ["cr_item_sk", "cr_order_number"],
                      ["cr_return_amount"], ["r_amt"])
    j = P.HashJoin(_scan("catalog_sales"), cr,
                   (E.col("cs_item_sk"), E.col("cs_order_number")),
                   (E.col("cr_item_sk"), E.col("cr_order_number")),
                   P.JoinType.LEFT, "right")
    dt = _scan("date_dim").filter(E.col("d_date_sk").between(300, 400))
    it = _scan("item").filter(
        E.col("i_current_price").between(E.lit(10, T.decimal(7, 2)), E.lit(250, T.decimal(7, 2))))
    j = _j(j, dt, ["cs_sold_date_sk"], ["d_date_sk"])
    j = _j(j, it, ["cs_item_sk"], ["i_item_sk"])
    j = _j(j, _scan("warehouse"), ["cs_warehouse_sk"], ["w_warehouse_sk"])
    net = (E.col("cs_sales_price").cast(T.decimal(17, 2))
           - E.coalesce(E.col("r_amt").cast(T.decimal(17, 2)),
                        E.lit(0).cast(T.decimal(17, 2))))
    pivot = E.lit(350)
    agg = j.aggregate(
        [E.col("w_state"), E.col("i_item_id")],
        [
            E.AggExpr("sum", E.if_(E.col("cs_sold_date_sk") < pivot, net,
                                   E.lit(0).cast(T.decimal(17, 2))), "sales_before"),
            E.AggExpr("sum", E.if_(E.col("cs_sold_date_sk") >= pivot, net,
                                   E.lit(0).cast(T.decimal(17, 2))), "sales_after"),
        ],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("w_state")), E.SortOrder(E.col("i_item_id"))], fetch=100
    )


def q9() -> P.PlanNode:
    """Five quantity-bucket CASE selectors between two bucket averages
    (scalar subqueries as chained single-row cross joins)."""
    plan = _scan("reason").filter(E.col("r_reason_sk") == E.lit(1))
    cases = []
    for i, (lo, hi) in enumerate([(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)]):
        b = _scan("store_sales").filter(E.col("ss_quantity").between(lo, hi)).aggregate(
            [],
            [
                E.AggExpr("count", None, f"cnt_{i}"),
                E.AggExpr("avg", E.col("ss_ext_discount_amt").cast(T.FLOAT64), f"disc_{i}"),
                E.AggExpr("avg", E.col("ss_net_paid").cast(T.FLOAT64), f"paid_{i}"),
            ],
        )
        plan = _cross(plan, b)
        cases.append(
            E.if_(E.col(f"cnt_{i}") > E.lit(100 * (i + 1)),
                  E.col(f"disc_{i}"), E.col(f"paid_{i}")).alias(f"bucket{i + 1}")
        )
    return plan.project([E.col("r_reason_sk")] + cases)


def q28() -> P.PlanNode:
    """Six list-price-band (avg, count, distinct-count) triples cross-joined
    into one row (distinct+avg via group-by-price decomposition)."""
    plan = None
    outs = []
    bands = [(0, 5000), (5000, 10000), (10000, 15000), (15000, 20000),
             (20000, 25000), (25000, 30000)]
    for i, (lo, hi) in enumerate(bands):
        per_price = _scan("store_sales").filter(
            E.col("ss_list_price").between(
                E.lit(lo // 100, T.decimal(7, 2)), E.lit(hi // 100, T.decimal(7, 2)))
        ).aggregate([E.col("ss_list_price")], [E.AggExpr("count", None, "n")])
        per_price.max_groups = 1 << 14
        b = per_price.aggregate(
            [],
            [
                E.AggExpr("count", None, f"distinct_{i}"),
                E.AggExpr("sum", E.col("ss_list_price") * E.col("n"), f"weighted_{i}"),
                E.AggExpr("sum", E.col("n"), f"cnt_{i}"),
            ],
        )
        plan = b if plan is None else _cross(plan, b)
        outs += [
            (E.col(f"weighted_{i}").cast(T.FLOAT64)
             / E.col(f"cnt_{i}").cast(T.FLOAT64)).alias(f"b{i + 1}_lp"),
            E.col(f"cnt_{i}").alias(f"b{i + 1}_cnt"),
            E.col(f"distinct_{i}").alias(f"b{i + 1}_cntd"),
        ]
    return plan.project(outs)


def _channel_people(fact: str, cust_col: str, date_col: str) -> P.PlanNode:
    j = _j(_scan(fact), _scan("date_dim").filter(E.col("d_month_seq").between(12, 23)),
           [date_col], ["d_date_sk"])
    j = _j(j, _scan("customer"), [cust_col], ["c_customer_sk"])
    agg = j.aggregate(
        [E.col("c_last_name"), E.col("c_first_name"), E.col("d_date_sk")],
        [E.AggExpr("count", None, "n")],
    )
    agg.max_groups = 1 << 16
    return agg


def q38(max_groups: int = 1 << 16) -> P.PlanNode:
    """Customers appearing in ALL three channels (INTERSECT as semi-joins)."""
    ss = _channel_people("store_sales", "ss_customer_sk", "ss_sold_date_sk")
    cs = _channel_people("catalog_sales", "cs_bill_customer_sk", "cs_sold_date_sk")
    ws = _channel_people("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk")
    keys = lambda p: tuple(E.col(c).alias(f"{p}_{c}") for c in  # noqa: E731
                           ("c_last_name", "c_first_name", "d_date_sk"))
    cs2 = cs.project(list(keys("cs")))
    ws2 = ws.project(list(keys("ws")))
    on = (E.col("c_last_name"), E.col("c_first_name"), E.col("d_date_sk"))
    j = P.HashJoin(ss, cs2, on, tuple(E.col(f"cs_{c.name}") for c in on),
                   P.JoinType.LEFT_SEMI, "right")
    j = P.HashJoin(j, ws2, on, tuple(E.col(f"ws_{c.name}") for c in on),
                   P.JoinType.LEFT_SEMI, "right")
    return j.aggregate([], [E.AggExpr("count", None, "num")])


def q87(max_groups: int = 1 << 16) -> P.PlanNode:
    """Store-only customers (EXCEPT as anti-joins)."""
    ss = _channel_people("store_sales", "ss_customer_sk", "ss_sold_date_sk")
    cs = _channel_people("catalog_sales", "cs_bill_customer_sk", "cs_sold_date_sk")
    ws = _channel_people("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk")
    keys = lambda p: tuple(E.col(c).alias(f"{p}_{c}") for c in  # noqa: E731
                           ("c_last_name", "c_first_name", "d_date_sk"))
    cs2 = cs.project(list(keys("cs")))
    ws2 = ws.project(list(keys("ws")))
    on = (E.col("c_last_name"), E.col("c_first_name"), E.col("d_date_sk"))
    j = P.HashJoin(ss, cs2, on, tuple(E.col(f"cs_{c.name}") for c in on),
                   P.JoinType.LEFT_ANTI, "right")
    j = P.HashJoin(j, ws2, on, tuple(E.col(f"ws_{c.name}") for c in on),
                   P.JoinType.LEFT_ANTI, "right")
    return j.aggregate([], [E.AggExpr("count", None, "num")])


def q61() -> P.PlanNode:
    """Promotional vs all sales for one category/month (two single-row
    aggregates cross-joined into a ratio)."""
    dt = _scan("date_dim").filter((E.col("d_year") == E.lit(1999)) & (E.col("d_moy") == E.lit(11)))
    it = _scan("item").filter(E.col("i_category") == E.lit("Jewelry"))
    ca = _scan("customer_address").filter(E.col("ca_gmt_offset") == E.lit(-5))
    base = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    base = _j(base, it, ["ss_item_sk"], ["i_item_sk"])
    base = _j(base, _scan("customer"), ["ss_customer_sk"], ["c_customer_sk"])
    base = _j(base, ca, ["c_current_addr_sk"], ["ca_address_sk"])
    pr = _scan("promotion").filter(
        (E.col("p_channel_dmail") == E.lit("Y")) | (E.col("p_channel_email") == E.lit("Y"))
        | (E.col("p_channel_tv") == E.lit("Y"))
    )
    promo = _j(base, pr, ["ss_promo_sk"], ["p_promo_sk"]).aggregate(
        [], [E.AggExpr("sum", E.col("ss_ext_sales_price"), "promotions")]
    )
    total = base.aggregate([], [E.AggExpr("sum", E.col("ss_ext_sales_price"), "total")])
    j = _cross(promo, total)
    return j.project(
        [E.col("promotions"), E.col("total"),
         (E.col("promotions").cast(T.FLOAT64) / E.col("total").cast(T.FLOAT64)
          * E.lit(100.0)).alias("promo_pct")]
    )


def q66(max_groups: int = 1 << 10) -> P.PlanNode:
    """Warehouse monthly shipping profile: 12 sum(case moy) columns per
    measure, web + catalog unioned, grouped by warehouse."""
    sm = _scan("ship_mode").filter(E.col("sm_type").isin("AIR", "EXPRESS"))
    td = _scan("time_dim").filter(E.col("t_hour").between(8, 17))

    def chan(fact, date_col, time_col, mode_col, wh_col, price_col, net_col):
        j = _j(_scan(fact), _scan("date_dim").filter(E.col("d_year") == E.lit(1999)),
               [date_col], ["d_date_sk"])
        j = _j(j, td, [time_col], ["t_time_sk"])
        j = _j(j, sm, [mode_col], ["sm_ship_mode_sk"])
        j = _j(j, _scan("warehouse"), [wh_col], ["w_warehouse_sk"])
        aggs = []
        for m in range(1, 13):
            aggs.append(E.AggExpr(
                "sum", E.if_(E.col("d_moy") == E.lit(m), E.col(price_col),
                             E.lit(0).cast(T.decimal(17, 2))), f"sales_m{m}"))
        for m in range(1, 13):
            aggs.append(E.AggExpr(
                "sum", E.if_(E.col("d_moy") == E.lit(m), E.col(net_col),
                             E.lit(0).cast(T.decimal(17, 2))), f"net_m{m}"))
        agg = j.aggregate(
            [E.col("w_warehouse_name"), E.col("w_warehouse_sq_ft"), E.col("w_state")],
            aggs,
        )
        agg.max_groups = max_groups
        return agg

    u = P.Union((
        chan("web_sales", "ws_sold_date_sk", "ws_sold_time_sk", "ws_ship_mode_sk",
             "ws_warehouse_sk", "ws_ext_sales_price", "ws_net_paid"),
        chan("catalog_sales", "cs_sold_date_sk", "cs_sold_time_sk", "cs_ship_mode_sk",
             "cs_warehouse_sk", "cs_sales_price", "cs_net_profit"),
    ))
    aggs = [E.AggExpr("sum", E.col(f"sales_m{m}"), f"sales_m{m}") for m in range(1, 13)]
    aggs += [E.AggExpr("sum", E.col(f"net_m{m}"), f"net_m{m}") for m in range(1, 13)]
    agg = u.aggregate(
        [E.col("w_warehouse_name"), E.col("w_warehouse_sq_ft"), E.col("w_state")], aggs
    )
    agg.max_groups = max_groups
    return agg.sort([E.SortOrder(E.col("w_warehouse_name"))], fetch=100)


def q84(max_groups: int = 1 << 14) -> P.PlanNode:
    """Customers in one city within an income band, with store returns
    (reached through the returns' demographic key)."""
    ib = _scan("income_band").filter(
        (E.col("ib_lower_bound") >= E.lit(30000)) & (E.col("ib_upper_bound") <= E.lit(100000)))
    ca = _scan("customer_address").filter(E.col("ca_city").isin("city5", "city10", "city15", "city20"))
    j = _j(_scan("customer"), ca, ["c_current_addr_sk"], ["ca_address_sk"])
    j = _j(j, _scan("household_demographics"), ["c_current_hdemo_sk"], ["hd_demo_sk"])
    j = _j(j, ib, ["hd_income_band_sk"], ["ib_income_band_sk"])
    j = _j(j, _scan("customer_demographics"), ["c_current_cdemo_sk"], ["cd_demo_sk"])
    sr = _scan("store_returns").aggregate(
        [E.col("sr_cdemo_sk")], [E.AggExpr("count", None, "n_r")]
    )
    sr.max_groups = 1 << 12
    j = P.HashJoin(j, sr.project([E.col("sr_cdemo_sk")]),
                   (E.col("cd_demo_sk"),), (E.col("sr_cdemo_sk"),),
                   P.JoinType.LEFT_SEMI, "right")
    return j.project(
        [E.col("c_customer_id"), E.col("c_last_name"), E.col("c_first_name")]
    ).sort([E.SortOrder(E.col("c_customer_id"))], fetch=100)


def q91(max_groups: int = 1 << 10) -> P.PlanNode:
    """Call-center catalog-return losses by demographic segment."""
    dt = _scan("date_dim").filter(E.col("d_year").isin(1999, 2000, 2001))
    cd = _scan("customer_demographics").filter(
        ((E.col("cd_marital_status") == E.lit("M")) & (E.col("cd_education_status") == E.lit("Unknown")))
        | ((E.col("cd_marital_status") == E.lit("W")) & (E.col("cd_education_status") == E.lit("Advanced Degree")))
        | ((E.col("cd_marital_status") == E.lit("S")) & (E.col("cd_education_status") == E.lit("College")))
        | ((E.col("cd_marital_status") == E.lit("D")) & (E.col("cd_education_status") == E.lit("Primary")))
    )
    hd = _scan("household_demographics").filter(
        E.col("hd_buy_potential").isin(">10000", "Unknown", "5001-10000"))
    ca = _scan("customer_address").filter(E.col("ca_gmt_offset").isin(-7, -6, -5))
    j = _j(_scan("catalog_returns"), dt, ["cr_returned_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("call_center"), ["cr_call_center_sk"], ["cc_call_center_sk"])
    j = _j(j, _scan("customer"), ["cr_returning_customer_sk"], ["c_customer_sk"])
    j = _j(j, cd, ["c_current_cdemo_sk"], ["cd_demo_sk"])
    j = _j(j, hd, ["c_current_hdemo_sk"], ["hd_demo_sk"])
    j = _j(j, ca, ["c_current_addr_sk"], ["ca_address_sk"])
    agg = j.aggregate(
        [E.col("cc_name"), E.col("cd_marital_status"), E.col("cd_education_status")],
        [E.AggExpr("sum", E.col("cr_net_loss"), "returns_loss")],
    )
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("returns_loss"), ascending=False),
         E.SortOrder(E.col("cc_name"))],
        fetch=100,
    )


def q64(max_groups: int = 1 << 16) -> P.PlanNode:
    """Cross-channel item purchases: store sales of returned-then-kept
    catalog items, per item/store/year, self-joined across two years
    (BASELINE configs[3] names this query; demographic chain reduced to
    hd→income_band, documented)."""
    cr = _returns_agg("catalog_returns", ["cr_item_sk", "cr_order_number"],
                      ["cr_return_amount"], ["r_amt"])
    csj = P.HashJoin(_scan("catalog_sales"), cr,
                     (E.col("cs_item_sk"), E.col("cs_order_number")),
                     (E.col("cr_item_sk"), E.col("cr_order_number")),
                     P.JoinType.LEFT, "right")
    cs_ui = csj.aggregate(
        [E.col("cs_item_sk")],
        [E.AggExpr("sum", E.col("cs_ext_list_price"), "sale"),
         E.AggExpr("sum", E.coalesce(E.col("r_amt"), E.lit(0, T.decimal(17, 2))), "refund")],
    )
    cs_ui.max_groups = max_groups
    cs_ui = cs_ui.filter(
        E.col("sale").cast(T.FLOAT64) > E.lit(2.0) * E.col("refund").cast(T.FLOAT64)
    ).project([E.col("cs_item_sk").alias("ui_item_sk")])

    it = _scan("item").filter(E.col("i_color").isin("red", "blue", "navy", "plum"))
    # the hd→income_band chain is a pure per-customer filter (both links are
    # 1:1): reduce it to an eligible-customer semi-join on the fact BEFORE
    # the wide join chain so static join capacities don't compound
    ib = _scan("income_band").filter(
        (E.col("ib_lower_bound") >= E.lit(20000)) & (E.col("ib_upper_bound") <= E.lit(150000)))
    elig = _j(_scan("customer"), _scan("household_demographics"),
              ["c_current_hdemo_sk"], ["hd_demo_sk"])
    elig = _j(elig, ib, ["hd_income_band_sk"], ["ib_income_band_sk"])
    elig = elig.project([E.col("c_customer_sk").alias("elig_cust")])
    ss = P.HashJoin(_scan("store_sales"), it.project([E.col("i_item_sk").alias("color_item")]),
                    (E.col("ss_item_sk"),), (E.col("color_item"),),
                    P.JoinType.LEFT_SEMI, "right")
    ss = P.HashJoin(ss, cs_ui, (E.col("ss_item_sk"),), (E.col("ui_item_sk"),),
                    P.JoinType.LEFT_SEMI, "right")
    ss = P.HashJoin(ss, elig, (E.col("ss_customer_sk"),), (E.col("elig_cust"),),
                    P.JoinType.LEFT_SEMI, "right")
    j = P.HashJoin(
        ss, _scan("store_returns"),
        (E.col("ss_item_sk"), E.col("ss_ticket_number")),
        (E.col("sr_item_sk"), E.col("sr_ticket_number")),
        P.JoinType.INNER, "right",
    )
    j = _j(j, _scan("date_dim"), ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, it, ["ss_item_sk"], ["i_item_sk"])
    cross_sales = j.aggregate(
        [E.col("i_product_name"), E.col("i_item_sk"), E.col("s_store_name"),
         E.col("s_zip"), E.col("d_year")],
        [
            E.AggExpr("count", None, "cnt"),
            E.AggExpr("sum", E.col("ss_wholesale_cost"), "s1"),
            E.AggExpr("sum", E.col("ss_list_price"), "s2"),
            E.AggExpr("sum", E.col("ss_coupon_amt"), "s3"),
        ],
    )
    cross_sales.max_groups = max_groups
    cs1 = cross_sales.filter(E.col("d_year") == E.lit(1999)).project(
        [E.col("i_product_name").alias("pn1"), E.col("i_item_sk").alias("ik1"),
         E.col("s_store_name").alias("sn1"), E.col("s_zip").alias("z1"),
         E.col("cnt").alias("cnt1"), E.col("s1").alias("y1_s1"),
         E.col("s2").alias("y1_s2"), E.col("s3").alias("y1_s3")]
    )
    cs2 = cross_sales.filter(E.col("d_year") == E.lit(2000)).project(
        [E.col("i_item_sk").alias("ik2"), E.col("s_store_name").alias("sn2"),
         E.col("s_zip").alias("z2"), E.col("cnt").alias("cnt2"),
         E.col("s1").alias("y2_s1"), E.col("s2").alias("y2_s2"),
         E.col("s3").alias("y2_s3")]
    )
    j2 = P.HashJoin(cs1, cs2, (E.col("ik1"), E.col("sn1"), E.col("z1")),
                    (E.col("ik2"), E.col("sn2"), E.col("z2")), P.JoinType.INNER, "right")
    keep = j2.filter(E.col("cnt2") <= E.col("cnt1"))
    return keep.sort(
        [E.SortOrder(E.col("pn1")), E.SortOrder(E.col("sn1")),
         E.SortOrder(E.col("cnt2")), E.SortOrder(E.col("ik1"))],
        fetch=100,
    )


# ---------------------------------------------------------------------------
# Final-breadth family (q14/q23/q24/q41/q46/q49/q54/q58/q77/q78/q83/q90):
# cross-channel item intersections with an average-sales benchmark, frequent-
# item + best-customer scalar thresholds, returns-ratio rankings, channel
# profit rollups, and morning/evening traffic ratios. Reference parity:
# spark/src/test CometTPCDSQuerySuite runs all 99; literals here are adapted
# to the skewed generator domains above like the rest of this module.
# ---------------------------------------------------------------------------


def q41(max_groups: int = 1 << 12) -> P.PlanNode:
    """Distinct product names of manufacturers that make color-themed items
    (EXISTS over an item self-join)."""
    inner = _scan("item").filter(
        ((E.col("i_category") == E.lit("Women"))
         & E.col("i_color").isin("red", "blue", "navy", "plum"))
        | ((E.col("i_category") == E.lit("Men"))
           & E.col("i_color").isin("black", "white", "olive", "salmon"))
    ).aggregate([E.col("i_manufact")], [E.AggExpr("count", None, "item_cnt")])
    inner.max_groups = 1 << 10
    them = inner.filter(E.col("item_cnt") > E.lit(0)).project(
        [E.col("i_manufact").alias("m2")])
    it = _scan("item").filter(E.col("i_manufact_id").between(100, 600))
    j = P.HashJoin(it, them, (E.col("i_manufact"),), (E.col("m2"),),
                   P.JoinType.LEFT_SEMI, "right")
    agg = j.aggregate([E.col("i_product_name")], [E.AggExpr("count", None, "n")])
    agg.max_groups = max_groups
    return agg.project([E.col("i_product_name")]).sort(
        [E.SortOrder(E.col("i_product_name"))], fetch=100)


def q90() -> P.PlanNode:
    """Morning-vs-evening web order ratio for mid-size web pages."""
    wp = _scan("web_page").filter(E.col("wp_char_count").between(2500, 5000))

    def half(lo: int, hi: int, name: str) -> P.PlanNode:
        td = _scan("time_dim").filter(E.col("t_hour").between(lo, hi))
        j = _j(_scan("web_sales"), td, ["ws_sold_time_sk"], ["t_time_sk"])
        j = _j(j, wp, ["ws_web_page_sk"], ["wp_web_page_sk"])
        return j.aggregate([], [E.AggExpr("count", None, name)])

    j = _cross(half(6, 7, "amc"), half(14, 15, "pmc"))
    return j.project([
        (E.col("amc").cast(T.FLOAT64) / E.col("pmc").cast(T.FLOAT64)).alias("am_pm_ratio")
    ])


def q90_scalar(session) -> P.PlanNode:
    """AM/PM web sales ratio through two scalar subqueries (JAX
    ``tpcds.py:1143``): the scalar-subquery form of q90, which joins its two
    counts instead."""
    def band(lo, hi):
        td = _scan("time_dim").filter(E.col("t_hour").between(lo, hi))
        j = _j(_scan("web_sales"), td, ["ws_sold_time_sk"], ["t_time_sk"])
        agg = j.aggregate([], [E.AggExpr("count", None, "cnt")])
        agg.max_groups = 8
        return agg

    am = session.scalar_subquery(band(8, 9))
    pm = session.scalar_subquery(band(19, 20))
    one = _scan("time_dim").limit(1)
    return one.project([(am.cast(T.FLOAT64) / pm.cast(T.FLOAT64)).alias("am_pm_ratio")])


def q88(session) -> P.PlanNode:
    """Eight half-hour-band store-sales counts as scalar subqueries, one row
    (JAX ``tpcds.py:1330``, q88's cross join of counts)."""
    def band(h, mlo, mhi):
        td = _scan("time_dim").filter(
            (E.col("t_hour") == E.lit(h)) & (E.col("t_minute").between(mlo, mhi)))
        hd = _scan("household_demographics").filter(E.col("hd_dep_count") == E.lit(5))
        st = _scan("store").filter(E.col("s_store_name") == E.lit("store_0"))
        j = _j(_scan("store_sales"), hd, ["ss_hdemo_sk"], ["hd_demo_sk"])
        j = _j(j, td, ["ss_sold_time_sk"], ["t_time_sk"])
        j = _j(j, st, ["ss_store_sk"], ["s_store_sk"])
        agg = j.aggregate([], [E.AggExpr("count", None, "cnt")])
        agg.max_groups = 8
        return agg

    subs = [session.scalar_subquery(band(h, 30 * half, 30 * half + 29))
            for h in (8, 9, 10, 11) for half in (0, 1)]
    one = _scan("time_dim").limit(1)
    return one.project([s_.alias(f"h{i}") for i, s_ in enumerate(subs)])


def q46(max_groups: int = 1 << 14) -> P.PlanNode:
    """Weekend ticket totals for dep-4/vehicle-3 households where the
    customer's current city differs from the city bought in."""
    dn = _scan("household_demographics").filter(
        (E.col("hd_dep_count") == E.lit(4)) | (E.col("hd_vehicle_count") == E.lit(3)))
    dt = _scan("date_dim").filter(
        E.col("d_dow").isin(0, 6) & E.col("d_year").isin(1999, 2000, 2001))
    st = _scan("store").filter(E.col("s_city").isin("city0", "city2"))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, st, ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, dn, ["ss_hdemo_sk"], ["hd_demo_sk"])
    j = _j(j, _scan("customer_address"), ["ss_addr_sk"], ["ca_address_sk"])
    per_ticket = j.aggregate(
        [E.col("ss_ticket_number"), E.col("ss_customer_sk"), E.col("ca_city")],
        [E.AggExpr("sum", E.col("ss_coupon_amt"), "amt"),
         E.AggExpr("sum", E.col("ss_net_profit"), "profit")])
    per_ticket.max_groups = max_groups
    j2 = _j(per_ticket, _scan("customer"), ["ss_customer_sk"], ["c_customer_sk"])
    cur = _scan("customer_address").project(
        [E.col("ca_address_sk").alias("cur_addr_sk"),
         E.col("ca_city").alias("current_city")])
    j2 = _j(j2, cur, ["c_current_addr_sk"], ["cur_addr_sk"])
    j2 = j2.filter(E.col("ca_city") != E.col("current_city"))
    return j2.project(
        [E.col("c_last_name"), E.col("c_first_name"),
         E.col("ca_city").alias("bought_city"), E.col("ss_ticket_number"),
         E.col("amt"), E.col("profit")]
    ).sort(
        [E.SortOrder(E.col("c_last_name")), E.SortOrder(E.col("c_first_name")),
         E.SortOrder(E.col("bought_city")), E.SortOrder(E.col("ss_ticket_number"))],
        fetch=100)


def q58(max_groups: int = 1 << 12) -> P.PlanNode:
    """Items whose per-sale quantity profile agrees across all three
    channels over a window (the revenue-parity query reshaped onto average
    quantities — the generator's channel volumes differ by design, so raw
    revenue parity would be vacuous)."""
    dt = _scan("date_dim").filter(E.col("d_week_seq").between(1, 40))

    def chan(fact: str, date_col: str, item_col: str, qty_col: str, out: str) -> P.PlanNode:
        j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        j = _j(j, _scan("item"), [item_col], ["i_item_sk"])
        a = j.aggregate(
            [E.col("i_item_id")],
            [E.AggExpr("avg", E.col(qty_col).cast(T.FLOAT64), out)])
        a.max_groups = max_groups
        return a

    ss = chan("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_quantity", "ss_item_rev")
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_quantity", "cs_item_rev"
              ).project([E.col("i_item_id").alias("cs_item_id"), E.col("cs_item_rev")])
    ws = chan("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_quantity", "ws_item_rev"
              ).project([E.col("i_item_id").alias("ws_item_id"), E.col("ws_item_rev")])
    j = P.HashJoin(ss, cs, (E.col("i_item_id"),), (E.col("cs_item_id"),),
                   P.JoinType.INNER, "right")
    j = P.HashJoin(j, ws, (E.col("i_item_id"),), (E.col("ws_item_id"),),
                   P.JoinType.INNER, "right")
    lo, hi = E.lit(0.8), E.lit(1.25)
    sr, cr, wr = E.col("ss_item_rev"), E.col("cs_item_rev"), E.col("ws_item_rev")
    f = j.filter(
        sr.between(lo * cr, hi * cr) & sr.between(lo * wr, hi * wr)
        & cr.between(lo * sr, hi * sr) & cr.between(lo * wr, hi * wr)
        & wr.between(lo * sr, hi * sr) & wr.between(lo * cr, hi * cr))
    third = E.lit(3.0)
    return f.project(
        [E.col("i_item_id"), sr, cr, wr,
         ((sr + cr + wr) / third).alias("average")]
    ).sort([E.SortOrder(E.col("i_item_id"))], fetch=100)


def q83(max_groups: int = 1 << 12) -> P.PlanNode:
    """Per-item returned quantities across the three return channels for a
    set of weeks, each as a share of the cross-channel average."""
    dt = _scan("date_dim").filter(E.col("d_week_seq").between(1, 50))

    def chan(fact: str, date_col: str, item_col: str, qty_col: str, out: str) -> P.PlanNode:
        j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        j = _j(j, _scan("item"), [item_col], ["i_item_sk"])
        a = j.aggregate(
            [E.col("i_item_id")],
            [E.AggExpr("sum", E.col(qty_col).cast(T.INT64), out)])
        a.max_groups = max_groups
        return a

    sr = chan("store_returns", "sr_returned_date_sk", "sr_item_sk", "sr_return_quantity", "sr_items")
    cr = chan("catalog_returns", "cr_returned_date_sk", "cr_item_sk", "cr_return_quantity", "cr_items"
              ).project([E.col("i_item_id").alias("cr_item_id"), E.col("cr_items")])
    wr = chan("web_returns", "wr_returned_date_sk", "wr_item_sk", "wr_return_quantity", "wr_items"
              ).project([E.col("i_item_id").alias("wr_item_id"), E.col("wr_items")])
    j = P.HashJoin(sr, cr, (E.col("i_item_id"),), (E.col("cr_item_id"),),
                   P.JoinType.INNER, "right")
    j = P.HashJoin(j, wr, (E.col("i_item_id"),), (E.col("wr_item_id"),),
                   P.JoinType.INNER, "right")
    total = (E.col("sr_items") + E.col("cr_items") + E.col("wr_items")).cast(T.FLOAT64)
    hundred_thirds = E.lit(300.0)

    def share(col: str, name: str) -> E.Expr:
        return (E.col(col).cast(T.FLOAT64) / total * hundred_thirds).alias(name)

    return j.project(
        [E.col("i_item_id"), E.col("sr_items"), share("sr_items", "sr_dev"),
         E.col("cr_items"), share("cr_items", "cr_dev"),
         E.col("wr_items"), share("wr_items", "wr_dev"),
         (total / E.lit(3.0)).alias("average")]
    ).sort([E.SortOrder(E.col("i_item_id")), E.SortOrder(E.col("sr_items"))],
           fetch=100)


def q77(max_groups: int = 1 << 12) -> P.PlanNode:
    """Channel sales/returns/profit rollup over a 60-day window; returns
    arrive through per-channel LEFT joins (web/store) and a scalar cross
    join (catalog, whose returns are not page-attributed)."""
    dt = _scan("date_dim").filter(E.col("d_date_sk").between(700, 760))

    def part(fact, date_col, key, sums):
        j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        a = j.aggregate([E.col(key)] if key else [],
                        [E.AggExpr("sum", E.col(c).cast(T.decimal(17, 2)), o)
                         for c, o in sums])
        a.max_groups = 1 << 8
        return a

    zero = E.lit(0).cast(T.decimal(17, 2))

    ss = part("store_sales", "ss_sold_date_sk", "ss_store_sk",
              [("ss_ext_sales_price", "sales"), ("ss_net_profit", "profit")])
    sr = part("store_returns", "sr_returned_date_sk", "sr_store_sk",
              [("sr_return_amt", "returns_amt"), ("sr_net_loss", "profit_loss")])
    store = P.HashJoin(ss, sr, (E.col("ss_store_sk"),), (E.col("sr_store_sk"),),
                       P.JoinType.LEFT, "right").project([
        E.lit("store channel").alias("channel"), E.col("ss_store_sk").alias("id"),
        E.col("sales"), E.coalesce(E.col("returns_amt"), zero).alias("returns_amt"),
        (E.col("profit") - E.coalesce(E.col("profit_loss"), zero)).alias("profit"),
    ])

    cs = part("catalog_sales", "cs_sold_date_sk", "cs_call_center_sk",
              [("cs_ext_sales_price", "sales"), ("cs_net_profit", "profit")])
    cr = part("catalog_returns", "cr_returned_date_sk", None,
              [("cr_return_amount", "returns_amt"), ("cr_net_loss", "profit_loss")])
    catalog = _cross(cs, cr).project([
        E.lit("catalog channel").alias("channel"),
        E.col("cs_call_center_sk").alias("id"), E.col("sales"),
        E.coalesce(E.col("returns_amt"), zero).alias("returns_amt"),
        (E.col("profit") - E.coalesce(E.col("profit_loss"), zero)).alias("profit"),
    ])

    ws = part("web_sales", "ws_sold_date_sk", "ws_web_page_sk",
              [("ws_ext_sales_price", "sales"), ("ws_net_profit", "profit")])
    wr = part("web_returns", "wr_returned_date_sk", "wr_web_page_sk",
              [("wr_return_amt", "returns_amt"), ("wr_net_loss", "profit_loss")])
    web = P.HashJoin(ws, wr, (E.col("ws_web_page_sk"),), (E.col("wr_web_page_sk"),),
                     P.JoinType.LEFT, "right").project([
        E.lit("web channel").alias("channel"), E.col("ws_web_page_sk").alias("id"),
        E.col("sales"), E.coalesce(E.col("returns_amt"), zero).alias("returns_amt"),
        (E.col("profit") - E.coalesce(E.col("profit_loss"), zero)).alias("profit"),
    ])

    u = P.Union((store, catalog, web))
    r = _rollup(u, [("channel", T.string(16)), ("id", T.INT64)],
                ["sales", "returns_amt", "profit"])
    agg = r.aggregate(
        [E.col("channel"), E.col("id"), E.col("lochierarchy")],
        [E.AggExpr("sum", E.col("sales"), "sales"),
         E.AggExpr("sum", E.col("returns_amt"), "returns_amt"),
         E.AggExpr("sum", E.col("profit"), "profit")])
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("lochierarchy"), ascending=False),
         E.SortOrder(E.col("channel")), E.SortOrder(E.col("id"))],
        fetch=100)


def q54(max_groups: int = 1 << 14) -> P.PlanNode:
    """Revenue segments ($5000 buckets) of store revenue from customers who
    bought Women's items from catalog/web in a given month."""
    month = _scan("date_dim").filter(E.col("d_month_seq") == E.lit(20))
    it = _scan("item").filter(E.col("i_category") == E.lit("Women"))
    cs = _scan("catalog_sales").project(
        [E.col("cs_sold_date_sk").alias("sold_date_sk"),
         E.col("cs_bill_customer_sk").alias("customer_sk"),
         E.col("cs_item_sk").alias("item_sk")])
    ws = _scan("web_sales").project(
        [E.col("ws_sold_date_sk").alias("sold_date_sk"),
         E.col("ws_bill_customer_sk").alias("customer_sk"),
         E.col("ws_item_sk").alias("item_sk")])
    u = P.Union((cs, ws))
    u = _j(u, it, ["item_sk"], ["i_item_sk"])
    u = _j(u, month, ["sold_date_sk"], ["d_date_sk"])
    my_customers = u.aggregate([E.col("customer_sk")], [E.AggExpr("count", None, "n")])
    my_customers.max_groups = 1 << 12
    follow = _scan("date_dim").filter(E.col("d_month_seq").between(21, 23))
    ss = _j(_scan("store_sales"), follow, ["ss_sold_date_sk"], ["d_date_sk"])
    ss = P.HashJoin(ss, my_customers.project([E.col("customer_sk")]),
                    (E.col("ss_customer_sk"),), (E.col("customer_sk"),),
                    P.JoinType.LEFT_SEMI, "right")
    rev = ss.aggregate([E.col("ss_customer_sk")],
                       [E.AggExpr("sum", E.col("ss_ext_sales_price").cast(T.INT64), "revenue")])
    rev.max_groups = max_groups
    seg = rev.project(
        [(E.col("revenue").cast(T.FLOAT64) / E.lit(5000.0)).cast(T.INT32).alias("segment")])
    agg = seg.aggregate([E.col("segment")], [E.AggExpr("count", None, "num_customers")])
    agg.max_groups = 1 << 10
    return agg.project(
        [E.col("segment"), E.col("num_customers"),
         (E.col("segment") * E.lit(5000)).alias("segment_base")]
    ).sort([E.SortOrder(E.col("segment")), E.SortOrder(E.col("num_customers"))],
           fetch=100)


def q78(max_groups: int = 1 << 16) -> P.PlanNode:
    """Store-vs-other-channel quantity ratios per (year, item, customer)
    for never-returned sales (LEFT ANTI against each returns table)."""
    yr = _scan("date_dim").filter(E.col("d_year") == E.lit(2000))

    def chan(fact, date_col, item_col, cust_col, ret, r_keys, s_keys, qty_col,
             price_col, prefix):
        f = P.HashJoin(_scan(fact), _scan(ret).project([E.col(k).alias(f"__r_{k}") for k in r_keys]),
                       tuple(E.col(k) for k in s_keys),
                       tuple(E.col(f"__r_{k}") for k in r_keys),
                       P.JoinType.LEFT_ANTI, "right")
        j = _j(f, yr, [date_col], ["d_date_sk"])
        a = j.aggregate(
            [E.col("d_year"), E.col(item_col), E.col(cust_col)],
            [E.AggExpr("sum", E.col(qty_col).cast(T.INT64), f"{prefix}_qty"),
             E.AggExpr("sum", E.col(price_col), f"{prefix}_sp")])
        a.max_groups = max_groups
        return a

    ss = chan("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
              "store_returns", ["sr_ticket_number", "sr_item_sk"],
              ["ss_ticket_number", "ss_item_sk"], "ss_quantity",
              "ss_sales_price", "ss")
    ws = chan("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_bill_customer_sk",
              "web_returns", ["wr_order_number", "wr_item_sk"],
              ["ws_order_number", "ws_item_sk"], "ws_quantity",
              "ws_sales_price", "ws").project(
        [E.col("d_year").alias("ws_year"), E.col("ws_item_sk"),
         E.col("ws_bill_customer_sk"), E.col("ws_qty"), E.col("ws_sp")])
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk",
              "catalog_returns", ["cr_order_number", "cr_item_sk"],
              ["cs_order_number", "cs_item_sk"], "cs_quantity",
              "cs_sales_price", "cs").project(
        [E.col("d_year").alias("cs_year"), E.col("cs_item_sk"),
         E.col("cs_bill_customer_sk"), E.col("cs_qty"), E.col("cs_sp")])
    j = P.HashJoin(ss, ws,
                   (E.col("d_year"), E.col("ss_item_sk"), E.col("ss_customer_sk")),
                   (E.col("ws_year"), E.col("ws_item_sk"), E.col("ws_bill_customer_sk")),
                   P.JoinType.LEFT, "right")
    j = P.HashJoin(j, cs,
                   (E.col("d_year"), E.col("ss_item_sk"), E.col("ss_customer_sk")),
                   (E.col("cs_year"), E.col("cs_item_sk"), E.col("cs_bill_customer_sk")),
                   P.JoinType.LEFT, "right")
    zero = E.lit(0).cast(T.INT64)
    dzero = E.lit(0).cast(T.decimal(17, 2))
    other_qty = E.coalesce(E.col("ws_qty"), zero) + E.coalesce(E.col("cs_qty"), zero)
    f = j.filter(other_qty > E.lit(0))
    return f.project(
        [E.col("d_year"), E.col("ss_item_sk"), E.col("ss_customer_sk"),
         (E.col("ss_qty").cast(T.FLOAT64) / other_qty.cast(T.FLOAT64)).alias("ratio"),
         E.col("ss_qty"), E.col("ss_sp"),
         other_qty.alias("other_chan_qty"),
         (E.coalesce(E.col("ws_sp"), dzero) + E.coalesce(E.col("cs_sp"), dzero)).alias("other_chan_sp")]
    ).sort(
        [E.SortOrder(E.col("ss_qty"), ascending=False),
         E.SortOrder(E.col("ss_item_sk")), E.SortOrder(E.col("ss_customer_sk"))],
        fetch=100)


def _q14_channel_item_keys(fact: str, date_col: str, item_col: str) -> P.PlanNode:
    dt = _scan("date_dim").filter(E.col("d_year").between(1999, 2001))
    j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
    j = _j(j, _scan("item"), [item_col], ["i_item_sk"])
    a = j.aggregate(
        [E.col("i_brand_id"), E.col("i_class"), E.col("i_category")],
        [E.AggExpr("count", None, "n")])
    a.max_groups = 1 << 14
    return a


def q14(max_groups: int = 1 << 14) -> P.PlanNode:
    """Cross-channel items (brand/class/category sold via all three
    channels), kept only where November sales beat the all-channel average
    (scalar benchmark), rolled up by channel/brand/class/category."""
    ss_keys = _q14_channel_item_keys("store_sales", "ss_sold_date_sk", "ss_item_sk")
    cs_keys = _q14_channel_item_keys("catalog_sales", "cs_sold_date_sk", "cs_item_sk"
                                     ).project([E.col("i_brand_id").alias("cb"),
                                                E.col("i_class").alias("cc"),
                                                E.col("i_category").alias("cg")])
    ws_keys = _q14_channel_item_keys("web_sales", "ws_sold_date_sk", "ws_item_sk"
                                     ).project([E.col("i_brand_id").alias("wb"),
                                                E.col("i_class").alias("wc"),
                                                E.col("i_category").alias("wg")])
    on = (E.col("i_brand_id"), E.col("i_class"), E.col("i_category"))
    both = P.HashJoin(ss_keys, cs_keys, on, (E.col("cb"), E.col("cc"), E.col("cg")),
                      P.JoinType.LEFT_SEMI, "right")
    both = P.HashJoin(both, ws_keys, on, (E.col("wb"), E.col("wc"), E.col("wg")),
                      P.JoinType.LEFT_SEMI, "right")
    cross_items = P.HashJoin(
        _scan("item"), both.project([E.col("i_brand_id").alias("xb"),
                                     E.col("i_class").alias("xc"),
                                     E.col("i_category").alias("xg")]),
        on, (E.col("xb"), E.col("xc"), E.col("xg")),
        P.JoinType.LEFT_SEMI, "right").project([E.col("i_item_sk").alias("xi")])

    years = _scan("date_dim").filter(E.col("d_year").between(1999, 2001))

    def sales_rows(fact, date_col, qty, price):
        j = _j(_scan(fact), years, [date_col], ["d_date_sk"])
        return j.project(
            [(E.col(qty).cast(T.INT64) * E.col(price).cast(T.INT64)).alias("sales")])

    avg_sales = P.Union((
        sales_rows("store_sales", "ss_sold_date_sk", "ss_quantity", "ss_list_price"),
        sales_rows("catalog_sales", "cs_sold_date_sk", "cs_quantity", "cs_list_price"),
        sales_rows("web_sales", "ws_sold_date_sk", "ws_quantity", "ws_sales_price"),
    )).aggregate([], [E.AggExpr("avg", E.col("sales").cast(T.FLOAT64), "average_sales")])

    nov = _scan("date_dim").filter(
        (E.col("d_year") == E.lit(2001)) & (E.col("d_moy") == E.lit(11)))

    def channel_sales(label, fact, date_col, item_col, qty, price):
        j = _j(_scan(fact), nov, [date_col], ["d_date_sk"])
        j = P.HashJoin(j, cross_items, (E.col(item_col),), (E.col("xi"),),
                       P.JoinType.LEFT_SEMI, "right")
        j = _j(j, _scan("item"), [item_col], ["i_item_sk"])
        a = j.aggregate(
            [E.col("i_brand_id"), E.col("i_class"), E.col("i_category")],
            [E.AggExpr("sum", (E.col(qty).cast(T.INT64) * E.col(price).cast(T.INT64)),
                       "sales"),
             E.AggExpr("count", None, "number_sales")])
        a.max_groups = max_groups
        f = _cross(a, avg_sales).filter(
            E.col("sales").cast(T.FLOAT64) > E.col("average_sales"))
        return f.project(
            [E.lit(label).alias("channel"), E.col("i_brand_id"), E.col("i_class"),
             E.col("i_category"), E.col("sales"), E.col("number_sales")])

    u = P.Union((
        channel_sales("store", "store_sales", "ss_sold_date_sk", "ss_item_sk",
                      "ss_quantity", "ss_list_price"),
        channel_sales("catalog", "catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                      "cs_quantity", "cs_list_price"),
        channel_sales("web", "web_sales", "ws_sold_date_sk", "ws_item_sk",
                      "ws_quantity", "ws_sales_price"),
    ))
    r = _rollup(u, [("channel", T.string(8)), ("i_brand_id", T.INT32),
                    ("i_class", T.string(12)), ("i_category", T.string(12))],
                ["sales", "number_sales"])
    agg = r.aggregate(
        [E.col("channel"), E.col("i_brand_id"), E.col("i_class"),
         E.col("i_category"), E.col("lochierarchy")],
        [E.AggExpr("sum", E.col("sales"), "sum_sales"),
         E.AggExpr("sum", E.col("number_sales"), "sum_number_sales")])
    agg.max_groups = max_groups
    return agg.sort(
        [E.SortOrder(E.col("lochierarchy"), ascending=False),
         E.SortOrder(E.col("channel")), E.SortOrder(E.col("i_brand_id")),
         E.SortOrder(E.col("i_class")), E.SortOrder(E.col("i_category"))],
        fetch=100)


def q23(max_groups: int = 1 << 16) -> P.PlanNode:
    """Catalog+web March sales restricted to frequently-sold items and
    best store customers (both scalar-thresholded subqueries)."""
    yrs = _scan("date_dim").filter(E.col("d_year").between(1999, 2001))
    freq = _j(_scan("store_sales"), yrs, ["ss_sold_date_sk"], ["d_date_sk"]).aggregate(
        [E.col("ss_item_sk"), E.col("ss_sold_date_sk")],
        [E.AggExpr("count", None, "cnt")])
    freq.max_groups = max_groups
    freq_items = freq.filter(E.col("cnt") > E.lit(1)).aggregate(
        [E.col("ss_item_sk")], [E.AggExpr("count", None, "nd")])
    freq_items.max_groups = 1 << 12
    freq_items = freq_items.project([E.col("ss_item_sk").alias("freq_item")])

    per_cust = _scan("store_sales").aggregate(
        [E.col("ss_customer_sk")],
        [E.AggExpr("sum", (E.col("ss_quantity").cast(T.INT64)
                           * E.col("ss_sales_price").cast(T.INT64)), "csales")])
    per_cust.max_groups = 1 << 14
    cmax = per_cust.aggregate([], [E.AggExpr("max", E.col("csales"), "tpcds_cmax")])
    best = _cross(per_cust, cmax).filter(
        (E.col("csales") * E.lit(20)) > E.col("tpcds_cmax")).project(
        [E.col("ss_customer_sk").alias("best_cust")])

    march = _scan("date_dim").filter(
        (E.col("d_year") == E.lit(2001)) & (E.col("d_moy") == E.lit(3)))

    def chan(fact, date_col, item_col, cust_col, qty, price):
        j = _j(_scan(fact), march, [date_col], ["d_date_sk"])
        j = P.HashJoin(j, freq_items, (E.col(item_col),), (E.col("freq_item"),),
                       P.JoinType.LEFT_SEMI, "right")
        j = P.HashJoin(j, best, (E.col(cust_col),), (E.col("best_cust"),),
                       P.JoinType.LEFT_SEMI, "right")
        return j.project(
            [(E.col(qty).cast(T.INT64) * E.col(price).cast(T.INT64)).alias("sales")])

    u = P.Union((
        chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
             "cs_bill_customer_sk", "cs_quantity", "cs_list_price"),
        chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
             "ws_bill_customer_sk", "ws_quantity", "ws_sales_price"),
    ))
    return u.aggregate([], [E.AggExpr("sum", E.col("sales"), "sum_sales")])


def q24(max_groups: int = 1 << 14) -> P.PlanNode:
    """Returned-sale net-paid by customer/store/color where the customer's
    zip differs from the store's, kept above 5% of the overall average."""
    sr = _scan("store_returns").project(
        [E.col("sr_ticket_number").alias("rt"), E.col("sr_item_sk").alias("ri")])
    j = P.HashJoin(_scan("store_sales"), sr,
                   (E.col("ss_ticket_number"), E.col("ss_item_sk")),
                   (E.col("rt"), E.col("ri")), P.JoinType.INNER, "right")
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, _scan("item"), ["ss_item_sk"], ["i_item_sk"])
    j = _j(j, _scan("customer"), ["ss_customer_sk"], ["c_customer_sk"])
    j = _j(j, _scan("customer_address"), ["c_current_addr_sk"], ["ca_address_sk"])
    j = j.filter(E.col("ca_zip") != E.col("s_zip"))
    ssales = j.aggregate(
        [E.col("c_last_name"), E.col("c_first_name"), E.col("s_store_name"),
         E.col("i_color")],
        [E.AggExpr("sum", E.col("ss_net_paid"), "netpaid")])
    ssales.max_groups = max_groups
    avg_all = ssales.aggregate([], [E.AggExpr("avg", E.col("netpaid").cast(T.FLOAT64),
                                              "avg_netpaid")])
    red = ssales.filter(E.col("i_color") == E.lit("red"))
    out = _cross(red, avg_all).filter(
        E.col("netpaid").cast(T.FLOAT64) > (E.lit(0.05) * E.col("avg_netpaid")))
    return out.project(
        [E.col("c_last_name"), E.col("c_first_name"), E.col("s_store_name"),
         E.col("netpaid")]
    ).sort(
        [E.SortOrder(E.col("c_last_name")), E.SortOrder(E.col("c_first_name")),
         E.SortOrder(E.col("s_store_name")), E.SortOrder(E.col("netpaid"))],
        fetch=100)


# ---------------------------------------------------------------------------
# Windows, MathFunc and the variance aggregates (JAX ``tpcds.py``: q98 :1163,
# q12/q20 :1255-1300, q36/q86/q70/q67 :1521-1665, the window family
# :1672-1905, q39 :3001, q17 :3453, q49 :3919)
# ---------------------------------------------------------------------------


def q98(max_groups: int = 1 << 12) -> P.PlanNode:
    """Item revenue with class-relative ratio via a window sum."""
    dt = _scan("date_dim").filter((E.col("d_year") == E.lit(1999)) & (E.col("d_moy").between(2, 3)))
    it = _scan("item").filter(E.col("i_category").isin("Sports", "Books", "Home"))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, it, ["ss_item_sk"], ["i_item_sk"])
    agg = j.aggregate(
        [E.col("i_item_id"), E.col("i_item_desc"), E.col("i_category"),
         E.col("i_class"), E.col("i_current_price")],
        [E.AggExpr("sum", E.col("ss_ext_sales_price"), "itemrevenue")],
    )
    agg.max_groups = max_groups
    win = P.Window(
        agg,
        (E.WindowExpr(
            "sum", E.col("itemrevenue"), "class_revenue",
            partition_by=(E.col("i_class"),),
            frame=E.WindowFrame("rows", None, None),
        ),),
    )
    return win.project(
        [E.col("i_item_id"), E.col("i_item_desc"), E.col("i_category"), E.col("i_class"),
         E.col("i_current_price"), E.col("itemrevenue"),
         (E.col("itemrevenue").cast(T.FLOAT64) * E.lit(100.0)
          / E.col("class_revenue").cast(T.FLOAT64)).alias("revenueratio")]
    ).sort(
        [E.SortOrder(E.col("i_category")), E.SortOrder(E.col("i_class")),
         E.SortOrder(E.col("i_item_id")), E.SortOrder(E.col("i_item_desc")),
         E.SortOrder(E.col("revenueratio"))],
        fetch=100,
    )


def _channel_ratio_query(fact: str, item_col: str, price_col: str, date_col: str,
                         max_groups: int) -> P.PlanNode:
    """q12/q20/q98 shape: item revenue with class-relative window ratio."""
    dt = _scan("date_dim").filter((E.col("d_year") == E.lit(1999)) & (E.col("d_moy").between(2, 3)))
    it = _scan("item").filter(E.col("i_category").isin("Sports", "Books", "Home"))
    j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
    j = _j(j, it, [item_col], ["i_item_sk"])
    agg = j.aggregate(
        [E.col("i_item_id"), E.col("i_item_desc"), E.col("i_category"),
         E.col("i_class"), E.col("i_current_price")],
        [E.AggExpr("sum", E.col(price_col), "itemrevenue")],
    )
    agg.max_groups = max_groups
    win = P.Window(
        agg,
        (E.WindowExpr(
            "sum", E.col("itemrevenue"), "class_revenue",
            partition_by=(E.col("i_class"),),
            frame=E.WindowFrame("rows", None, None),
        ),),
    )
    return win.project(
        [E.col("i_item_id"), E.col("i_item_desc"), E.col("i_category"), E.col("i_class"),
         E.col("i_current_price"), E.col("itemrevenue"),
         (E.col("itemrevenue").cast(T.FLOAT64) * E.lit(100.0)
          / E.col("class_revenue").cast(T.FLOAT64)).alias("revenueratio")]
    ).sort(
        [E.SortOrder(E.col("i_category")), E.SortOrder(E.col("i_class")),
         E.SortOrder(E.col("i_item_id")), E.SortOrder(E.col("i_item_desc")),
         E.SortOrder(E.col("revenueratio"))],
        fetch=100,
    )


def q12(max_groups: int = 1 << 12) -> P.PlanNode:
    """Web-channel item revenue ratio (q98 shape over web_sales)."""
    return _channel_ratio_query("web_sales", "ws_item_sk", "ws_ext_sales_price",
                                "ws_sold_date_sk", max_groups)


def q20(max_groups: int = 1 << 12) -> P.PlanNode:
    """Catalog-channel item revenue ratio (q98 shape over catalog_sales)."""
    return _channel_ratio_query("catalog_sales", "cs_item_sk", "cs_ext_sales_price",
                                "cs_sold_date_sk", max_groups)


def _margin_rollup_query(fact: str, date_col: str, item_col: str, profit_col: str,
                         sales_col, store_side, max_groups: int) -> P.PlanNode:
    """q36/q86 shape: category/class gross-margin rollup + rank within parent."""
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2001))
    j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
    j = _j(j, _scan("item"), [item_col], ["i_item_sk"])
    payloads = [profit_col] + ([sales_col] if sales_col else [])
    if store_side:
        st = _scan("store").filter(E.col("s_state").isin("TN", "CA", "TX", "NY"))
        j = _j(j, st, ["ss_store_sk"], ["s_store_sk"])
    r = _rollup(j, [("i_category", T.string(12)), ("i_class", T.string(12))], payloads)
    aggs = [E.AggExpr("sum", E.col(profit_col), "profit_sum")]
    if sales_col:
        aggs.append(E.AggExpr("sum", E.col(sales_col), "sales_sum"))
    agg = r.aggregate([E.col("i_category"), E.col("i_class"), E.col("lochierarchy")], aggs)
    agg.max_groups = max_groups
    if sales_col:
        metric = (E.col("profit_sum").cast(T.FLOAT64)
                  / E.col("sales_sum").cast(T.FLOAT64)).alias("gross_margin")
    else:
        metric = E.col("profit_sum").cast(T.FLOAT64).alias("gross_margin")
    proj = agg.project(
        [metric, E.col("i_category"), E.col("i_class"), E.col("lochierarchy")]
    )
    win = P.Window(
        proj,
        (E.WindowExpr(
            "rank", None, "rank_within_parent",
            partition_by=(E.col("lochierarchy"),
                          E.if_(E.col("lochierarchy") == E.lit(0),
                                E.col("i_category"), E.lit(None, T.string(12)))),
            order_by=(E.SortOrder(E.col("gross_margin")),),
        ),),
    )
    return win.sort(
        [E.SortOrder(E.col("lochierarchy"), ascending=False),
         E.SortOrder(E.if_(E.col("lochierarchy") == E.lit(0),
                           E.col("i_category"), E.lit(None, T.string(12)))),
         E.SortOrder(E.col("rank_within_parent"))],
        fetch=100,
    )


def q36(max_groups: int = 1 << 14) -> P.PlanNode:
    """Store gross margin by category/class rollup, ranked within parent."""
    return _margin_rollup_query("store_sales", "ss_sold_date_sk", "ss_item_sk",
                                "ss_net_profit", "ss_ext_sales_price", True, max_groups)


def q86(max_groups: int = 1 << 14) -> P.PlanNode:
    """Web net profit by category/class rollup, ranked within parent."""
    return _margin_rollup_query("web_sales", "ws_sold_date_sk", "ws_item_sk",
                                "ws_net_profit", None, False, max_groups)


def q70(max_groups: int = 1 << 14) -> P.PlanNode:
    """Store profit rollup(s_state, s_county) restricted to the 5 most
    profitable states (inner ranked aggregate as a semi-join filter)."""
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(12, 23))
    inner = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    inner = _j(inner, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    st_profit = inner.aggregate(
        [E.col("s_state")], [E.AggExpr("sum", E.col("ss_net_profit"), "state_profit")]
    )
    st_profit.max_groups = 64
    ranked = P.Window(
        st_profit,
        (E.WindowExpr(
            "rank", None, "ranking",
            order_by=(E.SortOrder(E.col("state_profit"), ascending=False),),
        ),),
    ).filter(E.col("ranking") <= E.lit(5)).project([E.col("s_state").alias("top_state")])
    st = P.HashJoin(
        _scan("store"), ranked, (E.col("s_state"),), (E.col("top_state"),),
        P.JoinType.LEFT_SEMI, "right",
    )
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, st, ["ss_store_sk"], ["s_store_sk"])
    r = _rollup(j, [("s_state", T.string(2)), ("s_county", T.string(20))], ["ss_net_profit"])
    agg = r.aggregate(
        [E.col("s_state"), E.col("s_county"), E.col("lochierarchy")],
        [E.AggExpr("sum", E.col("ss_net_profit"), "total_sum")],
    )
    agg.max_groups = max_groups
    win = P.Window(
        agg,
        (E.WindowExpr(
            "rank", None, "rank_within_parent",
            partition_by=(E.col("lochierarchy"),
                          E.if_(E.col("lochierarchy") == E.lit(0),
                                E.col("s_state"), E.lit(None, T.string(2)))),
            order_by=(E.SortOrder(E.col("total_sum"), ascending=False),),
        ),),
    )
    return win.sort(
        [E.SortOrder(E.col("lochierarchy"), ascending=False),
         E.SortOrder(E.if_(E.col("lochierarchy") == E.lit(0),
                           E.col("s_state"), E.lit(None, T.string(2)))),
         E.SortOrder(E.col("rank_within_parent"))],
        fetch=100,
    )


def q67(max_groups: int = 1 << 16) -> P.PlanNode:
    """8-level store-sales rollup ranked within category (top 100 each)."""
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(12, 23))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, _scan("item"), ["ss_item_sk"], ["i_item_sk"])
    j = j.project(
        [E.col("i_category"), E.col("i_class"), E.col("i_brand"), E.col("i_product_name"),
         E.col("d_year"), E.col("d_qoy"), E.col("d_moy"), E.col("s_store_id"),
         (E.col("ss_sales_price") * E.col("ss_quantity")).alias("sales_amt")]
    )
    r = _rollup(
        j,
        [("i_category", T.string(12)), ("i_class", T.string(12)), ("i_brand", T.string(30)),
         ("i_product_name", T.string(24)), ("d_year", T.INT32), ("d_qoy", T.INT32),
         ("d_moy", T.INT32), ("s_store_id", T.string(16))],
        ["sales_amt"],
    )
    agg = r.aggregate(
        [E.col("i_category"), E.col("i_class"), E.col("i_brand"), E.col("i_product_name"),
         E.col("d_year"), E.col("d_qoy"), E.col("d_moy"), E.col("s_store_id")],
        [E.AggExpr("sum", E.col("sales_amt"), "sumsales")],
    )
    agg.max_groups = max_groups
    win = P.Window(
        agg,
        (E.WindowExpr(
            "rank", None, "rk",
            partition_by=(E.col("i_category"),),
            order_by=(E.SortOrder(E.col("sumsales"), ascending=False),),
        ),),
    ).filter(E.col("rk") <= E.lit(100))
    return win.sort(
        [E.SortOrder(E.col("i_category")), E.SortOrder(E.col("i_class")),
         E.SortOrder(E.col("i_brand")), E.SortOrder(E.col("i_product_name")),
         E.SortOrder(E.col("d_year")), E.SortOrder(E.col("d_qoy")),
         E.SortOrder(E.col("d_moy")), E.SortOrder(E.col("s_store_id")),
         E.SortOrder(E.col("sumsales")), E.SortOrder(E.col("rk"))],
        fetch=100,
    )


_ALL_FRAME = E.WindowFrame("rows", None, None)


def _deviation_query(group_key: str, time_col: str, max_groups: int) -> P.PlanNode:
    """q53/q63 shape: per-manufacturer/manager period sales vs their average;
    keep periods deviating >10%."""
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(12, 23))
    it = _scan("item").filter(E.col("i_category").isin("Books", "Home", "Sports"))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, it, ["ss_item_sk"], ["i_item_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    agg = j.aggregate(
        [E.col(group_key), E.col(time_col)],
        [E.AggExpr("sum", E.col("ss_sales_price"), "sum_sales")],
    )
    agg.max_groups = max_groups
    win = P.Window(
        agg,
        (E.WindowExpr("avg", E.col("sum_sales").cast(T.FLOAT64), "avg_period_sales",
                      partition_by=(E.col(group_key),), frame=_ALL_FRAME),),
    )
    dev = win.filter(
        E.if_(
            E.col("avg_period_sales") > E.lit(0.0),
            (E.UnaryOp("abs", E.col("sum_sales").cast(T.FLOAT64) - E.col("avg_period_sales"))
             / E.col("avg_period_sales")),
            E.lit(None, T.FLOAT64),
        )
        > E.lit(0.1)
    )
    return dev.sort(
        [E.SortOrder(E.col("avg_period_sales")), E.SortOrder(E.col("sum_sales")),
         E.SortOrder(E.col(group_key)), E.SortOrder(E.col(time_col))],
        fetch=100,
    )


def q53(max_groups: int = 1 << 14) -> P.PlanNode:
    """Manufacturer quarterly sales deviating >10% from their average."""
    return _deviation_query("i_manufact_id", "d_qoy", max_groups)


def q63(max_groups: int = 1 << 14) -> P.PlanNode:
    """Manager monthly sales deviating >10% from their average."""
    return _deviation_query("i_manager_id", "d_moy", max_groups)


def q89(max_groups: int = 1 << 16) -> P.PlanNode:
    """Brand/store monthly sales deviating from the in-store yearly average."""
    dt = _scan("date_dim").filter(E.col("d_year") == E.lit(2000))
    it = _scan("item").filter(E.col("i_category").isin("Books", "Electronics", "Sports",
                                                       "Men", "Jewelry", "Women"))
    j = _j(_scan("store_sales"), dt, ["ss_sold_date_sk"], ["d_date_sk"])
    j = _j(j, it, ["ss_item_sk"], ["i_item_sk"])
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    agg = j.aggregate(
        [E.col("i_category"), E.col("i_class"), E.col("i_brand"),
         E.col("s_store_name"), E.col("s_county"), E.col("d_moy")],
        [E.AggExpr("sum", E.col("ss_sales_price"), "sum_sales")],
    )
    agg.max_groups = max_groups
    win = P.Window(
        agg,
        (E.WindowExpr("avg", E.col("sum_sales").cast(T.FLOAT64), "avg_monthly_sales",
                      partition_by=(E.col("i_category"), E.col("i_brand"),
                                    E.col("s_store_name"), E.col("s_county")),
                      frame=_ALL_FRAME),),
    )
    dev = win.filter(
        E.if_(
            E.col("avg_monthly_sales") != E.lit(0.0),
            (E.UnaryOp("abs", E.col("sum_sales").cast(T.FLOAT64) - E.col("avg_monthly_sales"))
             / E.col("avg_monthly_sales")),
            E.lit(None, T.FLOAT64),
        )
        > E.lit(0.1)
    )
    return dev.sort(
        [E.SortOrder(E.col("sum_sales").cast(T.FLOAT64) - E.col("avg_monthly_sales")),
         E.SortOrder(E.col("s_store_name")), E.SortOrder(E.col("i_category")),
         E.SortOrder(E.col("i_class")), E.SortOrder(E.col("i_brand")),
         E.SortOrder(E.col("d_moy"))],
        fetch=100,
    )


def _lag_lead_trend(fact: str, date_col: str, item_col: str, price_col: str,
                    entity_scan: str, entity_key: str, fact_key: str, entity_name: str,
                    max_groups: int) -> P.PlanNode:
    """q47/q57 shape: monthly sums with same-partition lag/lead neighbours,
    kept where the year-2000 month deviates >10% from the yearly average."""
    dt = _scan("date_dim").filter(E.col("d_year").isin(1999, 2000, 2001))
    j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
    j = _j(j, _scan("item"), [item_col], ["i_item_sk"])
    j = _j(j, _scan(entity_scan), [fact_key], [entity_key])
    agg = j.aggregate(
        [E.col("i_category"), E.col("i_brand"), E.col(entity_name),
         E.col("d_year"), E.col("d_moy")],
        [E.AggExpr("sum", E.col(price_col), "sum_sales")],
    )
    agg.max_groups = max_groups
    part = (E.col("i_category"), E.col("i_brand"), E.col(entity_name))
    order = (E.SortOrder(E.col("d_year")), E.SortOrder(E.col("d_moy")))
    win = P.Window(
        agg,
        (
            E.WindowExpr("avg", E.col("sum_sales").cast(T.FLOAT64), "avg_yearly",
                         partition_by=part + (E.col("d_year"),), frame=_ALL_FRAME),
            E.WindowExpr("lag", E.col("sum_sales"), "psum",
                         partition_by=part, order_by=order, offset=1),
            E.WindowExpr("lead", E.col("sum_sales"), "nsum",
                         partition_by=part, order_by=order, offset=1),
        ),
    )
    keep = win.filter(
        (E.col("d_year") == E.lit(2000))
        & (E.col("avg_yearly") > E.lit(0.0))
        & ((E.UnaryOp("abs", E.col("sum_sales").cast(T.FLOAT64) - E.col("avg_yearly"))
            / E.col("avg_yearly")) > E.lit(0.1))
    )
    return keep.sort(
        [E.SortOrder(E.col("sum_sales").cast(T.FLOAT64) - E.col("avg_yearly")),
         E.SortOrder(E.col("i_category")), E.SortOrder(E.col("i_brand")),
         E.SortOrder(E.col(entity_name)), E.SortOrder(E.col("d_moy"))],
        fetch=100,
    )


def q47(max_groups: int = 1 << 16) -> P.PlanNode:
    """Store monthly brand sales with lag/lead months around >10% outliers."""
    return _lag_lead_trend("store_sales", "ss_sold_date_sk", "ss_item_sk",
                           "ss_sales_price", "store", "s_store_sk", "ss_store_sk",
                           "s_store_name", max_groups)


def q57(max_groups: int = 1 << 16) -> P.PlanNode:
    """Catalog monthly brand sales by call center, lag/lead around outliers."""
    return _lag_lead_trend("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                           "cs_sales_price", "call_center", "cc_call_center_sk",
                           "cs_call_center_sk", "cc_name", max_groups)


def q51(max_groups: int = 1 << 16) -> P.PlanNode:
    """Web-vs-store cumulative revenue race per item over time."""
    dt = _scan("date_dim").filter(E.col("d_month_seq").between(12, 23))

    def cumulative(fact, item_col, date_col, price_col, item_out, date_out, cum_out):
        j = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        agg = j.aggregate(
            [E.col(item_col), E.col("d_date_sk")],
            [E.AggExpr("sum", E.col(price_col), "part_sales")],
        )
        agg.max_groups = max_groups
        win = P.Window(
            agg,
            (E.WindowExpr("sum", E.col("part_sales"), cum_out,
                          partition_by=(E.col(item_col),),
                          order_by=(E.SortOrder(E.col("d_date_sk")),),
                          frame=E.WindowFrame("rows", None, 0)),),
        )
        return win.project(
            [E.col(item_col).alias(item_out), E.col("d_date_sk").alias(date_out),
             E.col(cum_out)]
        )

    web = cumulative("web_sales", "ws_item_sk", "ws_sold_date_sk",
                     "ws_sales_price", "w_item_sk", "w_date_sk", "web_cumulative")
    store = cumulative("store_sales", "ss_item_sk", "ss_sold_date_sk",
                       "ss_sales_price", "s_item_sk", "s_date_sk", "store_cumulative")
    j = P.HashJoin(web, store, (E.col("w_item_sk"), E.col("w_date_sk")),
                   (E.col("s_item_sk"), E.col("s_date_sk")), P.JoinType.FULL, "right")
    both = j.project(
        [E.coalesce(E.col("w_item_sk"), E.col("s_item_sk")).alias("item_sk"),
         E.coalesce(E.col("w_date_sk"), E.col("s_date_sk")).alias("d_date_sk"),
         E.coalesce(E.col("web_cumulative"), E.lit(0)).alias("web_cumulative"),
         E.coalesce(E.col("store_cumulative"), E.lit(0)).alias("store_cumulative")]
    )
    run = P.Window(
        both,
        (
            E.WindowExpr("max", E.col("web_cumulative"), "web_max",
                         partition_by=(E.col("item_sk"),),
                         order_by=(E.SortOrder(E.col("d_date_sk")),),
                         frame=E.WindowFrame("rows", None, 0)),
            E.WindowExpr("max", E.col("store_cumulative"), "store_max",
                         partition_by=(E.col("item_sk"),),
                         order_by=(E.SortOrder(E.col("d_date_sk")),),
                         frame=E.WindowFrame("rows", None, 0)),
        ),
    )
    keep = run.filter(E.col("web_max") > E.col("store_max"))
    return keep.sort(
        [E.SortOrder(E.col("item_sk")), E.SortOrder(E.col("d_date_sk"))], fetch=100
    )


def q44(max_groups: int = 1 << 14) -> P.PlanNode:
    """Best and worst ten items by average net profit at one store,
    paired by rank (two-sided ranking + double item join)."""
    base = _scan("store_sales").filter(E.col("ss_store_sk") == E.lit(4))
    v = base.aggregate(
        [E.col("ss_item_sk")],
        [E.AggExpr("avg", E.col("ss_net_profit").cast(T.FLOAT64), "rank_col")],
    )
    v.max_groups = max_groups
    ranked = P.Window(
        v,
        (
            E.WindowExpr("rank", None, "rnk_asc",
                         order_by=(E.SortOrder(E.col("rank_col")),
                                   E.SortOrder(E.col("ss_item_sk")),)),
            E.WindowExpr("rank", None, "rnk_desc",
                         order_by=(E.SortOrder(E.col("rank_col"), ascending=False),
                                   E.SortOrder(E.col("ss_item_sk")),)),
        ),
    )
    asc = ranked.filter(E.col("rnk_asc") <= E.lit(10)).project(
        [E.col("rnk_asc").alias("rnk"), E.col("ss_item_sk").alias("worst_sk")]
    )
    desc = ranked.filter(E.col("rnk_desc") <= E.lit(10)).project(
        [E.col("rnk_desc").alias("rnk_d"), E.col("ss_item_sk").alias("best_sk")]
    )
    pair = P.HashJoin(asc, desc, (E.col("rnk"),), (E.col("rnk_d"),), P.JoinType.INNER, "right")
    i1 = _scan("item").project([E.col("i_item_sk").alias("i1_sk"),
                                E.col("i_product_name").alias("best_performing")])
    i2 = _scan("item").project([E.col("i_item_sk").alias("i2_sk"),
                                E.col("i_product_name").alias("worst_performing")])
    j = P.HashJoin(pair, i1, (E.col("best_sk"),), (E.col("i1_sk"),), P.JoinType.INNER, "right")
    j = P.HashJoin(j, i2, (E.col("worst_sk"),), (E.col("i2_sk"),), P.JoinType.INNER, "right")
    return j.project(
        [E.col("rnk"), E.col("best_performing"), E.col("worst_performing")]
    ).sort([E.SortOrder(E.col("rnk"))], fetch=100)


def q39(max_groups: int = 1 << 14) -> P.PlanNode:
    """Inventory coefficient-of-variation outliers in consecutive months
    (stdev/mean > 1, self-joined on month+1)."""
    j = _j(_scan("inventory"), _scan("date_dim"), ["inv_date_sk"], ["d_date_sk"])
    j = _j(j, _scan("item"), ["inv_item_sk"], ["i_item_sk"])
    j = _j(j, _scan("warehouse"), ["inv_warehouse_sk"], ["w_warehouse_sk"])
    base = j.filter(E.col("d_year") == E.lit(2000)).aggregate(
        [E.col("w_warehouse_sk"), E.col("i_item_sk"), E.col("d_moy")],
        [
            E.AggExpr("stddev_samp", E.col("inv_quantity_on_hand").cast(T.FLOAT64), "stdev"),
            E.AggExpr("avg", E.col("inv_quantity_on_hand").cast(T.FLOAT64), "mean"),
        ],
    )
    base.max_groups = max_groups
    cov = base.filter(
        E.if_(E.col("mean") == E.lit(0.0), E.lit(None, T.FLOAT64),
              E.col("stdev") / E.col("mean")) > E.lit(1.0)
    ).project([E.col("w_warehouse_sk"), E.col("i_item_sk"), E.col("d_moy"),
               E.col("mean"), (E.col("stdev") / E.col("mean")).alias("cov")])
    inv1 = cov.project([E.col("w_warehouse_sk").alias("w1"), E.col("i_item_sk").alias("i1"),
                        E.col("d_moy").alias("m1"), E.col("mean").alias("mean1"),
                        E.col("cov").alias("cov1")])
    inv2 = cov.project([E.col("w_warehouse_sk").alias("w2"), E.col("i_item_sk").alias("i2"),
                        (E.col("d_moy") - E.lit(1)).alias("m2_off"),
                        E.col("mean").alias("mean2"), E.col("cov").alias("cov2")])
    j2 = P.HashJoin(inv1, inv2, (E.col("w1"), E.col("i1"), E.col("m1")),
                    (E.col("w2"), E.col("i2"), E.col("m2_off")), P.JoinType.INNER, "right")
    return j2.sort(
        [E.SortOrder(E.col("w1")), E.SortOrder(E.col("i1")), E.SortOrder(E.col("m1")),
         E.SortOrder(E.col("cov1"))],
        fetch=100,
    )


def q17(max_groups: int = 1 << 16) -> P.PlanNode:
    """Quantity statistics across the store→return→catalog-rebuy chain,
    with count/avg/stdev computed from joined moment sums (the pre-
    aggregated catalog side carries count/sum/sum-of-squares)."""
    d1 = _scan("date_dim").filter(E.col("d_year") == E.lit(2000)).project(
        [E.col("d_date_sk").alias("d1_sk")])
    d2 = _scan("date_dim").filter(E.col("d_year").isin(2000, 2001)).project(
        [E.col("d_date_sk").alias("d2_sk")])
    d3 = _scan("date_dim").filter(E.col("d_year").isin(2000, 2001)).project(
        [E.col("d_date_sk").alias("d3_sk")])
    cs = _j(_scan("catalog_sales"), d3, ["cs_sold_date_sk"], ["d3_sk"])
    csq = E.col("cs_quantity").cast(T.INT64)
    cs_agg = cs.aggregate(
        [E.col("cs_bill_customer_sk"), E.col("cs_item_sk")],
        [
            E.AggExpr("count", None, "n3"),
            E.AggExpr("sum", csq, "s3"),
            E.AggExpr("sum", csq * csq, "ss3"),
        ],
    )
    cs_agg.max_groups = max_groups
    j = P.HashJoin(
        _scan("store_sales"), _scan("store_returns"),
        (E.col("ss_customer_sk"), E.col("ss_item_sk"), E.col("ss_ticket_number")),
        (E.col("sr_customer_sk"), E.col("sr_item_sk"), E.col("sr_ticket_number")),
        P.JoinType.INNER, "right",
    )
    j = _j(j, d1, ["ss_sold_date_sk"], ["d1_sk"])
    j = _j(j, d2, ["sr_returned_date_sk"], ["d2_sk"])
    j = P.HashJoin(j, cs_agg,
                   (E.col("ss_customer_sk"), E.col("ss_item_sk")),
                   (E.col("cs_bill_customer_sk"), E.col("cs_item_sk")),
                   P.JoinType.INNER, "right")
    j = _j(j, _scan("store"), ["ss_store_sk"], ["s_store_sk"])
    j = _j(j, _scan("item"), ["ss_item_sk"], ["i_item_sk"])
    q1 = E.col("ss_quantity").cast(T.INT64)
    q2 = E.col("sr_return_quantity").cast(T.INT64)
    agg = j.aggregate(
        [E.col("i_item_id"), E.col("i_item_desc"), E.col("s_state")],
        [
            E.AggExpr("sum", E.col("n3"), "cnt1"),
            E.AggExpr("sum", q1 * E.col("n3"), "sum1"),
            E.AggExpr("sum", q1 * q1 * E.col("n3"), "sumsq1"),
            E.AggExpr("sum", q2 * E.col("n3"), "sum2"),
            E.AggExpr("sum", q2 * q2 * E.col("n3"), "sumsq2"),
            E.AggExpr("sum", E.col("s3"), "sum3"),
            E.AggExpr("sum", E.col("ss3"), "sumsq3"),
        ],
    )
    agg.max_groups = max_groups
    f64 = lambda c: E.col(c).cast(T.FLOAT64)  # noqa: E731

    def stats(prefix, n, s, ss):
        avg = (f64(s) / f64(n)).alias(f"{prefix}_avg")
        var = ((f64(ss) - f64(s) * f64(s) / f64(n)) / (f64(n) - E.lit(1.0)))
        std = E.MathFunc("sqrt", (var,)).alias(f"{prefix}_stdev")
        return [avg, std]

    return agg.project(
        [E.col("i_item_id"), E.col("i_item_desc"), E.col("s_state"), E.col("cnt1")]
        + stats("store", "cnt1", "sum1", "sumsq1")
        + stats("ret", "cnt1", "sum2", "sumsq2")
        + stats("cat", "cnt1", "sum3", "sumsq3")
    ).sort(
        [E.SortOrder(E.col("i_item_id")), E.SortOrder(E.col("i_item_desc")),
         E.SortOrder(E.col("s_state"))],
        fetch=100,
    )


def q49(max_groups: int = 1 << 12) -> P.PlanNode:
    """Worst return ratios per channel: items ranked by quantity- and
    amount-return ratios, keeping the bottom 10 of either ranking."""
    dt = _scan("date_dim").filter((E.col("d_year") == E.lit(2000)) & (E.col("d_moy") == E.lit(12)))

    def chan(label, fact, ret, s_keys, r_keys, date_col, item_col, qty, paid,
             r_qty, r_amt):
        s = _j(_scan(fact), dt, [date_col], ["d_date_sk"])
        r = _scan(ret).filter(E.col(r_amt) > E.lit(100, T.decimal(7, 2))).project(
            [E.col(k).alias(f"__r_{k}") for k in r_keys]
            + [E.col(r_qty).alias("ret_qty"), E.col(r_amt).alias("ret_amt")])
        j = P.HashJoin(s, r, tuple(E.col(k) for k in s_keys),
                       tuple(E.col(f"__r_{k}") for k in r_keys),
                       P.JoinType.INNER, "right")
        a = j.aggregate(
            [E.col(item_col)],
            [E.AggExpr("sum", E.col("ret_qty").cast(T.INT64), "rq"),
             E.AggExpr("sum", E.col(qty).cast(T.INT64), "sq"),
             E.AggExpr("sum", E.col("ret_amt").cast(T.INT64), "ra"),
             E.AggExpr("sum", E.col(paid).cast(T.INT64), "sa")])
        a.max_groups = max_groups
        p = a.project(
            [E.col(item_col).alias("item"),
             (E.col("rq").cast(T.FLOAT64) / E.col("sq").cast(T.FLOAT64)).alias("return_ratio"),
             (E.col("ra").cast(T.FLOAT64) / E.col("sa").cast(T.FLOAT64)).alias("currency_ratio")])
        win = P.Window(p, (
            E.WindowExpr("rank", None, "return_rank",
                         order_by=(E.SortOrder(E.col("return_ratio")),)),
            E.WindowExpr("rank", None, "currency_rank",
                         order_by=(E.SortOrder(E.col("currency_ratio")),)),
        ))
        keep = win.filter((E.col("return_rank") <= E.lit(10))
                          | (E.col("currency_rank") <= E.lit(10)))
        return keep.project(
            [E.lit(label).alias("channel"), E.col("item"), E.col("return_ratio"),
             E.col("return_rank"), E.col("currency_rank")])

    web = chan("web", "web_sales", "web_returns",
               ["ws_order_number", "ws_item_sk"], ["wr_order_number", "wr_item_sk"],
               "ws_sold_date_sk", "ws_item_sk", "ws_quantity", "ws_net_paid",
               "wr_return_quantity", "wr_return_amt")
    cat = chan("catalog", "catalog_sales", "catalog_returns",
               ["cs_order_number", "cs_item_sk"], ["cr_order_number", "cr_item_sk"],
               "cs_sold_date_sk", "cs_item_sk", "cs_quantity", "cs_ext_sales_price",
               "cr_return_quantity", "cr_return_amount")
    st = chan("store", "store_sales", "store_returns",
              ["ss_ticket_number", "ss_item_sk"], ["sr_ticket_number", "sr_item_sk"],
              "ss_sold_date_sk", "ss_item_sk", "ss_quantity", "ss_net_paid",
              "sr_return_quantity", "sr_return_amt")
    u = P.Union((web, cat, st))
    return u.sort(
        [E.SortOrder(E.col("channel")), E.SortOrder(E.col("return_rank")),
         E.SortOrder(E.col("currency_rank")), E.SortOrder(E.col("item"))],
        fetch=100)


# the 99 queries: by number, then those that need a window, MathFunc or
# stddev_samp, then q88
QUERIES = {
    "q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7, "q8": q8, "q9": q9,
    "q10": q10, "q11": q11, "q13": q13, "q14": q14, "q15": q15, "q16": q16, "q18": q18,
    "q19": q19, "q21": q21, "q22": q22, "q23": q23, "q24": q24, "q25": q25, "q26": q26,
    "q27": q27, "q28": q28, "q29": q29, "q30": q30, "q31": q31, "q32": q32, "q33": q33,
    "q34": q34, "q35": q35, "q37": q37, "q38": q38, "q40": q40, "q41": q41, "q42": q42,
    "q43": q43, "q45": q45, "q46": q46, "q48": q48, "q50": q50, "q52": q52, "q54": q54,
    "q55": q55, "q56": q56, "q58": q58, "q59": q59, "q60": q60, "q61": q61, "q62": q62,
    "q64": q64, "q65": q65, "q66": q66, "q68": q68, "q69": q69, "q71": q71, "q72": q72,
    "q73": q73, "q74": q74, "q75": q75, "q76": q76, "q77": q77, "q78": q78, "q79": q79,
    "q80": q80, "q81": q81, "q82": q82, "q83": q83, "q84": q84, "q85": q85, "q87": q87,
    "q90": q90, "q91": q91, "q92": q92, "q93": q93, "q94": q94, "q95": q95, "q96": q96,
    "q97": q97, "q99": q99,
    # windows, MathFunc and stddev_samp, after the others so that each test
    # share (tests/_torch_tpcds.py) keeps its earlier queries
    "q12": q12, "q17": q17, "q20": q20, "q36": q36, "q39": q39, "q44": q44, "q47": q47,
    "q49": q49, "q51": q51, "q53": q53, "q57": q57, "q63": q63, "q67": q67, "q70": q70,
    "q86": q86, "q89": q89, "q98": q98,
    # scalar subqueries, last again
    "q88": q88,
}

# the queries whose plan function takes the session that will run the plan:
# their scalar subqueries are registered there
NEEDS_SESSION = frozenset({"q88"})


def plan(q: str, session=None) -> P.PlanNode:
    """The plan of query ``q``, built for ``session`` where the query
    registers scalar subqueries (``NEEDS_SESSION``)."""
    return QUERIES[q](session) if q in NEEDS_SESSION else QUERIES[q]()


def tables(q: str):
    """The tables query ``q`` reads, its scalar subqueries' included, each
    once, in plan order."""
    from datafusion_comet_tpu_torch.exec.engine import Session, subquery_ids

    s = Session(device="cpu")  # holds the subqueries the plan registers
    root = plan(q, s)
    plans = [root] + [s.subquery_plan(i) for i in sorted(subquery_ids(root))]
    return list(dict.fromkeys(t for p in plans for t in P.scan_tables(p)))

